"""Sharding over a mesh of devices: state-point grids (mesh.py) and long
order-parameter surfaces (surface.py).  The PyTorch port of the JAX
package's ``parallel/``, with the same public names."""

from .mesh import (
    GridMesh,
    grid_mesh,
    replicate,
    shard_axis,
    shard_map_mu_sweep,
    sharded_make_grid,
    sharded_mu_beta_sweep,
    sharded_joint_state_sweep,
    sharded_pore_state_sweep,
    sharded_trace_coexistence,
)
from .surface import (
    sharded_normalize_2d,
    sharded_normalize_long,
    sharded_relextrema,
    sharded_stencil_flags,
)

__all__ = [
    "grid_mesh",
    "replicate",
    "shard_axis",
    "shard_map_mu_sweep",
    "sharded_make_grid",
    "sharded_mu_beta_sweep",
    "sharded_joint_state_sweep",
    "sharded_pore_state_sweep",
    "sharded_trace_coexistence",
    "sharded_normalize_2d",
    "sharded_normalize_long",
    "sharded_relextrema",
    "sharded_stencil_flags",
]
