"""The data axis of the port (moldiff_tpu/parallel): process groups, the
mesh record, FSDP placements, launching one process per rank, and the
multi-process sampling helpers."""
from .mesh import (DATA_AXIS, EXPERT_AXIS, GRAPH_AXIS, MODEL_AXIS, Mesh, Placement,
                   fsdp_param_sharding, fsdp_placement, initialize_distributed,
                   make_mesh_from_config, pad_batch_to_multiple, shard_batch)
from . import multihost
