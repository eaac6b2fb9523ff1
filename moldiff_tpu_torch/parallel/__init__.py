"""The data, pipe and expert axes of the port (moldiff_tpu/parallel):
process groups, the mesh record, FSDP, pipe and expert placements, the
GPipe executor, launching one process per rank, and the multi-process
sampling helpers."""
from .mesh import (DATA_AXIS, EXPERT_AXIS, GRAPH_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, Placement,
                   ep_enabled, ep_param_sharding, fsdp_param_sharding, fsdp_placement,
                   initialize_distributed, make_mesh_expert, make_mesh_from_config,
                   make_mesh_pipe, pad_batch_to_multiple, pipe_enabled, shard_batch)
from . import multihost
