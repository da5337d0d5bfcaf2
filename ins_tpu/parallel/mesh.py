"""Device meshes and spatial sharding of the staggered fields.

No reference counterpart (the reference is single-device; SURVEY.md §2.5).
Design: the `(D, *N)` velocity / `(N...)` scalar fields are sharded over
spatial mesh axes ("x", "y"[, "z"]); XLA GSPMD inserts halo exchanges for
the radius-1 stencils and all-to-all transposes for the FFT Poisson solve. Ensemble/batch axes for closure training shard over a leading
"b" axis (data parallel).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "spatial_sharding", "shard_state", "SPATIAL_AXES"]

SPATIAL_AXES = ("x", "y", "z")


def make_mesh(shape=None, *, batch=1, devices=None):
    """Create a device mesh.

    `shape`: per-spatial-axis device counts, e.g. `(2, 4)` for a 2D domain.
    A leading data-parallel axis "b" of size `batch` is prepended when
    `batch > 1`. Default: all devices along the first spatial axis.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n // batch,)
    axes = (("b",) if batch > 1 else ()) + SPATIAL_AXES[: len(shape)]
    full = ((batch,) if batch > 1 else ()) + tuple(shape)
    if int(np.prod(full)) != n:
        raise ValueError(f"mesh shape {full} does not match {n} devices")
    dev_array = np.asarray(devices).reshape(full)
    return Mesh(dev_array, axes)


def spatial_sharding(mesh, ndim_field, *, is_vector=False, batched=False):
    """NamedSharding for a field: spatial dims over mesh spatial axes,
    component/batch dims replicated or over "b"."""
    spatial = [a for a in mesh.axis_names if a in SPATIAL_AXES]
    spec = []
    if batched:
        spec.append("b" if "b" in mesh.axis_names else None)
    if is_vector:
        spec.append(None)  # component axis replicated
    nspatial = ndim_field - len(spec)
    for d in range(nspatial):
        spec.append(spatial[d] if d < len(spatial) else None)
    return NamedSharding(mesh, P(*spec))


def shard_state(mesh, u, temp=None):
    """Place velocity (and temperature) with spatial sharding."""
    spatial = [a for a in mesh.axis_names if a in SPATIAL_AXES]
    for d, ax in enumerate(spatial):
        size = mesh.shape[ax]
        if u.shape[1 + d] % size != 0:
            raise ValueError(
                f"ghost-padded extent N[{d}]={u.shape[1 + d]} is not "
                f"divisible by mesh axis '{ax}' of size {size}; choose "
                f"n so that n + 2 (ghosts) divides the mesh"
            )
    us = jax.device_put(u, spatial_sharding(mesh, u.ndim, is_vector=True))
    if temp is None:
        return us, None
    ts = jax.device_put(temp, spatial_sharding(mesh, temp.ndim))
    return us, ts
