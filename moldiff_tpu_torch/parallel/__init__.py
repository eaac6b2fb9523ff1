"""The data, pipe, expert, graph and model axes of the port
(moldiff_tpu/parallel): process groups, the mesh record, FSDP, pipe,
expert and tensor-parallel placements, the GPipe executor, the
differentiable collectives of the graph and model axes, launching one
process per rank, and the multi-process sampling helpers."""
from .mesh import (DATA_AXIS, EXPERT_AXIS, GRAPH_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, Placement,
                   ep_enabled, ep_param_sharding, fsdp_param_sharding, fsdp_placement,
                   graph_enabled, initialize_distributed, make_mesh_2d, make_mesh_3d,
                   make_mesh_expert, make_mesh_from_config, make_mesh_pipe, pad_batch_to_multiple,
                   pair_sharding, pipe_enabled, shard_batch, tp_enabled, tp_param_sharding)
from . import multihost
