"""Multi-process training: the rank mesh, collectives with their gradients,
tensor parallelism, data parallelism and the sequence-parallel scan (the
counterpart of `fusionmamba_tpu/parallel/`)."""
from .data import local_dp_table, rank_rows, sync_gradients
from .mesh import Axis, DistInfo, Mesh, get_mesh, init_distributed, make_mesh, set_mesh
from .seq_scan import selective_scan_seq_parallel
from .sharding import (apply_tensor_parallel, gather_state_dict, param_specs, shard_state_dict,
                       spec_for)

__all__ = ["Axis", "DistInfo", "Mesh", "apply_tensor_parallel", "gather_state_dict",
           "get_mesh", "init_distributed", "local_dp_table", "make_mesh", "param_specs",
           "rank_rows", "selective_scan_seq_parallel", "set_mesh", "shard_state_dict",
           "spec_for", "sync_gradients"]
