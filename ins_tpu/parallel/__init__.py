"""Distributed execution over device meshes (domain decomposition, collectives).

The reference is single-device (SURVEY.md §2.5); this subpackage is designed
fresh: spatial sharding of `(D, *N)` fields over a `jax.sharding.Mesh`,
halo exchange by collective permutes, pencil FFTs, and data-parallel
closure training.
"""

from .halo import make_halo_fast_step, shard_interior  # noqa: F401
from .mesh import make_mesh, shard_state, spatial_sharding  # noqa: F401
