from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh, mesh_axes_for
from grove_tpu_torch.parallel.sharding import (
    LOGICAL_RULES,
    param_pspec,
    shard_params,
)

__all__ = [
    "MeshPlan",
    "build_mesh",
    "mesh_axes_for",
    "LOGICAL_RULES",
    "param_pspec",
    "shard_params",
]
