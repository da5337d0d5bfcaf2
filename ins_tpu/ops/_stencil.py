"""Static-slice stencil helpers.

All differential operators act on boxes (static index ranges) of ghost-padded
fields. Neighbor access is expressed as the same box shifted by +-1 in one
dimension — a static slice, which XLA fuses with the surrounding arithmetic
into a single loop over the box. This replaces the reference's
KernelAbstractions Cartesian-index kernels (src/operators.jl:29-37) with
XLA-native fused elementwise graphs; the uniform periodic hot path drops
the ghosts altogether (ops/fastpath.py).
"""

from __future__ import annotations

import jax.numpy as jnp

Box = tuple  # tuple[(start, stop), ...] 0-based half-open


def box_shape(box: Box) -> tuple:
    return tuple(e - s for (s, e) in box)


def slc(box: Box, **shifts_by_dim):
    """Slices of `box`; `slc(box, d0=+1)` shifts dimension 0 by +1."""
    shifts = {int(k[1:]): v for k, v in shifts_by_dim.items()}
    return tuple(
        slice(s + shifts.get(d, 0), e + shifts.get(d, 0))
        for d, (s, e) in enumerate(box)
    )


def shifted(box: Box, d: int, k: int):
    """Slices of `box` shifted by `k` along dimension `d`."""
    return tuple(
        slice(s + (k if i == d else 0), e + (k if i == d else 0))
        for i, (s, e) in enumerate(box)
    )


def take(f, box: Box, d: int | None = None, k: int = 0):
    """Read field values on `box`, optionally shifted by `k` along dim `d`."""
    if d is None or k == 0:
        return f[slc(box)]
    return f[shifted(box, d, k)]


def take2(f, box: Box, d1: int, k1: int, d2: int, k2: int):
    """Read field values on `box` shifted along two dimensions."""
    sl = list(slc(box))
    sl[d1] = slice(sl[d1].start + k1, sl[d1].stop + k1)
    sl[d2] = slice(sl[d2].start + k2, sl[d2].stop + k2)
    return f[tuple(sl)]


def seg(arr_1d, box: Box, d: int, shift: int = 0):
    """1-D metadata segment over `box` along dim `d`, broadcast-shaped.

    Returns `arr_1d[box[d][0]+shift : box[d][1]+shift]` reshaped to
    broadcast along dimension `d` of a `box`-shaped array.
    """
    s, e = box[d]
    D = len(box)
    shape = [1] * D
    shape[d] = e - s
    return jnp.reshape(arr_1d[s + shift : e + shift], shape)
