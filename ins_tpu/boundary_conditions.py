"""Boundary conditions: types, ghost metadata rules, and ghost-cell fills.

Re-design of IncompressibleNavierStokes.jl
`src/boundary_conditions.jl:1-516`. The four BC families are plain frozen
dataclasses used as *static* pytree metadata; the ghost-cell fills are pure
functions built from static slice updates (`x.at[plane].set(...)`) which XLA
fuses into the surrounding stencil computation. Hand-written pullbacks
(`apply_bc_*_pullback!` in the reference) are unnecessary: JAX autodiff
differentiates the slice updates exactly.

Conventions (0-based):
- Velocity fields have shape `(D, *N)` (component-first),
  scalar fields `(N...)`, where `N` includes one ghost layer per side
  (two on the left for `PressureBC`, cf. reference `padghost!` at
  `src/boundary_conditions.jl:39-61`).
- BCs are applied dimension-sequentially (left then right per dimension);
  the sequence is semantically significant for corner ghost values, matching
  the reference loop at `src/boundary_conditions.jl:159-166`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np


# --------------------------------------------------------------------------
# BC types
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PeriodicBC:
    """Periodic boundary conditions. Must be periodic on both sides."""


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Dirichlet velocity BC.

    `u` is one of:
    - None: no-slip (all velocity components zero),
    - a tuple of constants (one per velocity component),
    - a callable `u(alpha, *x, t)` returning the alpha-component at
      boundary coordinates `x` and time `t` (vectorized over jnp arrays).

    For the temperature equation, `u` is None (zero), a constant, or a
    callable `u(*x, t)`.
    """

    u: Any = None


@dataclasses.dataclass(frozen=True)
class SymmetricBC:
    """Symmetric BC: parallel velocity/pressure mirrored, normal velocity zero."""


@dataclasses.dataclass(frozen=True)
class PressureBC:
    """Pressure (outflow) BC: p = 0 on the boundary, zero-Neumann velocity."""


# --------------------------------------------------------------------------
# Ghost-coordinate padding and DOF offsets (grid metadata rules)
# Reference: src/boundary_conditions.jl:39-89
# --------------------------------------------------------------------------


def padghost(bc, x: np.ndarray, isright: bool) -> np.ndarray:
    """Pad volume-boundary coordinate vector with ghost coordinates."""
    if isinstance(bc, PeriodicBC):
        if isright:
            return np.append(x, x[-1] + (x[1] - x[0]))
        return np.insert(x, 0, x[0] - (x[-1] - x[-2]))
    if isinstance(bc, DirichletBC):
        # Infinitely thin boundary volume
        return np.append(x, x[-1]) if isright else np.insert(x, 0, x[0])
    if isinstance(bc, SymmetricBC):
        # Duplicate boundary volume
        if isright:
            return np.append(x, x[-1] + (x[-1] - x[-2]))
        return np.insert(x, 0, x[0] - (x[1] - x[0]))
    if isinstance(bc, PressureBC):
        # One thin ghost on the right; two on the left (so the left ghost
        # volume has a normal velocity component to its left).
        return np.append(x, x[-1]) if isright else np.insert(x, 0, [x[0], x[0]])
    raise TypeError(f"Unknown boundary condition {bc!r}")


def offset_u(bc, isright: bool, isnormal: bool) -> int:
    """Number of non-DOF velocity components at this boundary side."""
    if isinstance(bc, PeriodicBC):
        return 1
    if isinstance(bc, (DirichletBC, SymmetricBC)):
        return 1 + (isright and isnormal)
    if isinstance(bc, PressureBC):
        return 1 + ((not isright) and (not isnormal))
    raise TypeError(f"Unknown boundary condition {bc!r}")


def offset_p(bc, isright: bool) -> int:
    """Number of non-DOF pressure components at this boundary side."""
    if isinstance(bc, (PeriodicBC, DirichletBC, SymmetricBC)):
        return 1
    if isinstance(bc, PressureBC):
        return 1 + (not isright)
    raise TypeError(f"Unknown boundary condition {bc!r}")


# --------------------------------------------------------------------------
# Index helpers
# --------------------------------------------------------------------------

Box = tuple  # tuple[(start, stop), ...] per dimension, half-open, 0-based


def boundary_plane(beta: int, N, box: Box, isright: bool) -> Box:
    """Boundary layer just outside the DOF `box`, normal to dimension `beta`.

    Reference: `boundary` at src/boundary_conditions.jl:97-103.
    """
    i = box[beta][1] if isright else box[beta][0] - 1
    return tuple(
        (i, i + 1) if a == beta else (0, N[a]) for a in range(len(N))
    )


def box_slices(box: Box, shifts: dict[int, int] | None = None):
    """Convert a box to a tuple of slices, optionally shifted per dimension."""
    shifts = shifts or {}
    return tuple(
        slice(s + shifts.get(d, 0), e + shifts.get(d, 0))
        for d, (s, e) in enumerate(box)
    )


def plane_coords(coords_1d, box: Box):
    """Broadcastable coordinate arrays of a box from per-dim 1-D coords."""
    D = len(box)
    out = []
    for g, (s, e) in enumerate(box):
        shape = [1] * D
        shape[g] = e - s
        out.append(jnp.reshape(coords_1d[g][s:e], shape))
    return tuple(out)


# --------------------------------------------------------------------------
# Dirichlet boundary-value evaluation
# --------------------------------------------------------------------------


def _dirichlet_u_value(bc: DirichletBC, alpha, coords, t, dtype, dudt):
    shape = tuple(int(np.broadcast_shapes(*(c.shape for c in coords))[d]) for d in range(len(coords)))
    if bc.u is None:
        return jnp.zeros(shape, dtype)
    if isinstance(bc.u, tuple):
        val = jnp.zeros(shape, dtype) if dudt else jnp.full(shape, bc.u[alpha], dtype)
        return val
    if dudt:
        # Central difference in time of the boundary function,
        # cf. src/boundary_conditions.jl:352-357
        h = math.sqrt(float(np.finfo(dtype).eps)) / 2
        return (
            bc.u(alpha, *coords, t + h) - bc.u(alpha, *coords, t - h)
        ) / (2 * h) * jnp.ones(shape, dtype)
    return bc.u(alpha, *coords, t) * jnp.ones(shape, dtype)


def _dirichlet_temp_value(bc: DirichletBC, coords, t, dtype):
    shape = tuple(int(np.broadcast_shapes(*(c.shape for c in coords))[d]) for d in range(len(coords)))
    if bc.u is None:
        return jnp.zeros(shape, dtype)
    if isinstance(bc.u, (int, float)):
        return jnp.full(shape, bc.u, dtype)
    return bc.u(*coords, t) * jnp.ones(shape, dtype)


# --------------------------------------------------------------------------
# Ghost fills (functional versions of apply_bc_*!)
# --------------------------------------------------------------------------


def apply_bc_u(u, t, setup, *, dudt: bool = False, homogeneous: bool = False):
    """Apply velocity boundary conditions (pure function).

    `homogeneous=True` zeroes Dirichlet boundary values (for linear-solver
    iterations on BC-corrected unknowns).

    Reference: `apply_bc_u!` at src/boundary_conditions.jl:159-167 and the
    per-type methods at :276-495.
    """
    g = setup.grid
    for beta in range(g.dim):
        bcl, bcr = setup.boundary_conditions[beta]
        if homogeneous:
            bcl = DirichletBC() if isinstance(bcl, DirichletBC) else bcl
            bcr = DirichletBC() if isinstance(bcr, DirichletBC) else bcr
        u = _apply_bc_u_side(bcl, u, beta, t, setup, isright=False, dudt=dudt)
        u = _apply_bc_u_side(bcr, u, beta, t, setup, isright=True, dudt=dudt)
    return u


def apply_bc_p(p, t, setup):
    """Apply pressure boundary conditions (pure function)."""
    g = setup.grid
    for beta in range(g.dim):
        bcl, bcr = setup.boundary_conditions[beta]
        p = _apply_bc_p_side(bcl, p, beta, setup, isright=False)
        p = _apply_bc_p_side(bcr, p, beta, setup, isright=True)
    return p


def apply_bc_temp(temp, t, setup):
    """Apply temperature boundary conditions (pure function)."""
    g = setup.grid
    for beta in range(g.dim):
        bcl, bcr = setup.temperature.boundary_conditions[beta]
        temp = _apply_bc_temp_side(bcl, temp, beta, t, setup, isright=False)
        temp = _apply_bc_temp_side(bcr, temp, beta, t, setup, isright=True)
    return temp


# --------------------------------------------------------------------------
# Fill primitives.
#
# All ghost fills are expressed as gathers (`jnp.take` with a static wrap
# index) and masked selects — never scatter-updates. Besides fusing into
# one gather instead of two scatters, this avoids an XLA GSPMD partitioner miscompile observed with
# `x.at[plane].set(x[other_plane])` self-copies on sharded arrays.
# --------------------------------------------------------------------------


def _copy_index(N, plane, src):
    idx = np.arange(N)
    idx[plane] = src
    return jnp.asarray(idx)


def _take_dim(f, axis, idx):
    return jnp.take(f, idx, axis=axis)


def _plane_mask(N, beta, plane, extra_ndim=0):
    m = np.zeros(N, np.bool_)
    sl = tuple(plane if d == beta else slice(None) for d in range(len(N)))
    m[sl] = True
    m = m.reshape(m.shape + (1,) * extra_ndim)
    return jnp.asarray(m)


def _set_plane(f, N, beta, plane, value, axis_offset=0):
    """Select `value` on the plane `dim beta == plane` (broadcasts)."""
    mask = _plane_mask(N, beta, plane, extra_ndim=f.ndim - len(N) - axis_offset)
    if axis_offset:
        mask = jnp.reshape(mask, (1,) * axis_offset + mask.shape)
    return jnp.where(mask, value, f)


def _apply_bc_u_side(bc, u, beta, t, setup, *, isright, dudt=False):
    g = setup.grid
    D, N = g.dim, g.N
    axis = 1 + beta
    if isinstance(bc, PeriodicBC):
        if isright:
            return u  # both sides handled in the "left" call
        idx = np.arange(N[beta])
        idx[0] = N[beta] - 2
        idx[-1] = 1
        return _take_dim(u, axis, jnp.asarray(idx))
    if isinstance(bc, DirichletBC):
        for alpha in range(D):
            box = boundary_plane(beta, N, g.Iu[alpha], isright)
            plane = box[beta][0]
            coords = plane_coords(g.xu[alpha], box)
            val = _dirichlet_u_value(bc, alpha, coords, t, setup.dtype, dudt)
            # val has extent 1 along dim beta; broadcasts onto the plane
            comp = _set_plane(u[alpha], N, beta, plane, val)
            u = jnp.concatenate(
                [u[:alpha], comp[None], u[alpha + 1 :]], axis=0
            )
        return u
    if isinstance(bc, (SymmetricBC, PressureBC)):
        comps = []
        for alpha in range(D):
            box = boundary_plane(beta, N, g.Iu[alpha], isright)
            plane = box[beta][0]
            if isinstance(bc, SymmetricBC) and alpha == beta:
                comps.append(_set_plane(u[alpha], N, beta, plane, 0.0))
            else:
                src = plane - 1 if isright else plane + 1
                idx = _copy_index(N[beta], plane, src)
                comps.append(_take_dim(u[alpha], beta, idx))
        return jnp.stack(comps)
    raise TypeError(f"Unknown boundary condition {bc!r}")


def _apply_bc_p_side(bc, p, beta, setup, *, isright):
    g = setup.grid
    N = g.N
    if isinstance(bc, PeriodicBC):
        if isright:
            return p
        idx = np.arange(N[beta])
        idx[0] = N[beta] - 2
        idx[-1] = 1
        return _take_dim(p, beta, jnp.asarray(idx))
    if isinstance(bc, DirichletBC):
        return p  # not used, cf. src/boundary_conditions.jl:388
    if isinstance(bc, SymmetricBC):
        box = boundary_plane(beta, N, g.Ip, isright)
        plane = box[beta][0]
        src = plane - 1 if isright else plane + 1
        return _take_dim(p, beta, _copy_index(N[beta], plane, src))
    if isinstance(bc, PressureBC):
        box = boundary_plane(beta, N, g.Ip, isright)
        return _set_plane(p, N, beta, box[beta][0], 0.0)
    raise TypeError(f"Unknown boundary condition {bc!r}")


def _apply_bc_temp_side(bc, temp, beta, t, setup, *, isright):
    g = setup.grid
    N = g.N
    if isinstance(bc, PeriodicBC):
        return _apply_bc_p_side(bc, temp, beta, setup, isright=isright)
    if isinstance(bc, DirichletBC):
        box = boundary_plane(beta, N, g.Ip, isright)
        coords = plane_coords(g.xp, box)
        val = _dirichlet_temp_value(bc, coords, t, setup.dtype)
        return _set_plane(temp, N, beta, box[beta][0], val)
    if isinstance(bc, SymmetricBC):
        return _apply_bc_p_side(bc, temp, beta, setup, isright=isright)
    if isinstance(bc, PressureBC):
        # Symmetric BC for temperature, cf. src/boundary_conditions.jl:512
        return _apply_bc_p_side(SymmetricBC(), temp, beta, setup, isright=isright)
    raise TypeError(f"Unknown boundary condition {bc!r}")
