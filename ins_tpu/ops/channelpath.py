"""Wall-bounded (channel-topology) fast path.

Covers the reference's first-class wall-bounded hot configs
(examples/TurbulentChannel.jl; the BC-agnostic hot kernel is
src/operators.jl:634-690): x/y periodic uniform, z Dirichlet walls on a
(possibly stretched) wall-normal grid, steady constant body force,
explicit classic-row RK tableaus.

Design (re-designed for the accelerator, not a translation):

- **Interior layout, pinned wall slot.** Velocity is stored ghost-free
  as ``(3, nx, ny, nz)``.  u/v occupy all nz cell-centers; w's z-DOFs
  are the nz-1 interior faces in slots 0..nz-2 and slot nz-1 holds the
  top-wall face value (identically 0).  Because the bottom-wall face is
  ALSO 0, every periodic z-roll of w wraps the pinned slot around as
  exactly the correct wall ghost — w needs *no* boundary masking at
  all.  Only u/v z-shifts need a lane-edge select (ghost cell value =
  the Dirichlet wall velocity; the grid's "infinitely thin boundary
  volume" puts the ghost center on the wall, grid.py padghost).
- **Static z-metric vectors.** All stretched-grid coefficients
  (cell widths, face distances, interpolation weights A, eps-guarded
  inverse diffusion spacings, src/operators.jl:563-567) are
  precomputed 1-D vectors over interior slots, padded with zeros at
  the non-DOF w slot so masked terms vanish by construction.
- **Projection by fast diagonalization** (`ops/fdm.py`): x/y Fourier
  and z wall eigenbases are all dense tensor contractions — the
  stretched-wall equivalent of the periodic path's spectral solve.

The step is a roll graph that XLA fuses; its CPU tests check parity
against the ghosted slice graph (tests/test_channelpath.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..boundary_conditions import DirichletBC, PeriodicBC
from ..time_steppers.methods import ExplicitRungeKuttaMethod

__all__ = [
    "channelpath_applicable",
    "make_channel_metrics",
    "channel_convdiff_roll",
    "channel_divergence_roll",
    "channel_correct_roll",
    "make_channel_timestep",
    "strip_channel",
    "reghost_channel",
]


# --------------------------------------------------------------------------
# Applicability + layout
# --------------------------------------------------------------------------


def _const_wall_values(bc, D, dtype):
    """Per-component wall velocity of a static DirichletBC, or None."""
    if not isinstance(bc, DirichletBC):
        return None
    if bc.u is None:
        return (0.0,) * D
    if isinstance(bc.u, tuple) and all(
        isinstance(v, (int, float)) for v in bc.u
    ):
        return tuple(float(v) for v in bc.u)
    return None  # time/space-dependent walls stay on the slice graph


def channelpath_applicable(setup, method=None):
    """Channel topology: 3D, x/y periodic uniform, z Dirichlet walls with
    static wall velocities whose normal component is zero, no
    temperature, steady (constant or None) body force."""
    g = setup.grid
    if g.dim != 3 or setup.temperature is not None:
        return False
    if setup.closure_model is not None:
        return False
    for d in (0, 1):
        if not (g.periodic[d] and g.uniform[d]):
            return False
    if g.periodic[2]:
        return False
    bcl, bcr = setup.boundary_conditions[2]
    gb = _const_wall_values(bcl, 3, setup.dtype)
    gt = _const_wall_values(bcr, 3, setup.dtype)
    if gb is None or gt is None or gb[2] != 0.0 or gt[2] != 0.0:
        return False
    if method is not None:
        if not isinstance(method, ExplicitRungeKuttaMethod):
            return False
        # The step keeps one b-row accumulator, so every intermediate
        # (shifted-tableau) row may hold only its OWN stage's k — classic
        # RK44 and friends; 1-stage tableaus qualify trivially.
        A, ns = method.A, method.nstage
        if any(A[i][j] != 0.0 for i in range(ns - 1) for j in range(i)):
            return False
    return True


def strip_channel(u):
    """Ghosted -> interior channel layout: a plain 1-ghost strip. The
    stripped w field keeps the top-wall face (ghosted z slot nz) in its
    last slot — the pinned 0."""
    return u[:, 1:-1, 1:-1, 1:-1]


def reghost_channel(u_int, setup):
    """Interior channel layout -> ghosted + BC-filled field (exactly
    `apply_bc_u` of the zero-padded reghost for static walls)."""
    g = setup.grid
    dtype = u_int.dtype
    bcl, bcr = setup.boundary_conditions[2]
    gb = _const_wall_values(bcl, 3, dtype)
    gt = _const_wall_values(bcr, 3, dtype)
    u = jnp.pad(u_int, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="wrap")
    comps = []
    for a in range(3):
        if a == 2:
            lo = jnp.zeros(u.shape[1:3] + (1,), dtype)
            hi = jnp.zeros(u.shape[1:3] + (1,), dtype)
        else:
            lo = jnp.full(u.shape[1:3] + (1,), gb[a], dtype)
            hi = jnp.full(u.shape[1:3] + (1,), gt[a], dtype)
        comps.append(jnp.concatenate([lo, u[a], hi], axis=-1))
    out = jnp.stack(comps)
    assert out.shape[1:] == g.N
    return out


# --------------------------------------------------------------------------
# Static metric vectors
# --------------------------------------------------------------------------


class ChannelMetrics(NamedTuple):
    """Interior-slot z-metric vectors (numpy f64; cast at use site).

    Tangential components (u, v — all nz slots are DOFs):
      inv_dz      1/cell width (divisor of the b=z flux difference)
      inv_da_t    eps-guarded 1/(ghost-to-center distance below)
      inv_db_t    eps-guarded 1/(center-to-ghost distance above)
    Normal component (w — slots 0..nz-2 are DOFs, slot nz-1 pinned 0;
    every vector is 0 at slot nz-1 so non-DOF terms vanish):
      inv_duz     1/face-to-face distance (divisor + pressure gradient)
      inv_da_n    eps-guarded 1/cell-k width (lower z-gradient)
      inv_db_n    eps-guarded 1/cell-(k+1) width (upper z-gradient)
      az1, az2    A-weights interpolating u/v along z to the face
                  (transverse terms b=x,y; A[b][2] in grid.py)
      azz_m1, azz_m2, azz_c1, azz_c2
                  A[2][2] weight segments for the w-on-w convection
                  (m = lower flux, c = upper flux)
    Shared:
      om_z        z-factor of the cell volume (pressure box)
      dx, dy      uniform transverse spacings
      gb, gt      wall velocities (3,)
    """

    inv_dz: Any
    inv_da_t: Any
    inv_db_t: Any
    inv_duz: Any
    inv_da_n: Any
    inv_db_n: Any
    az1: Any
    az2: Any
    azz_m1: Any
    azz_m2: Any
    azz_c1: Any
    azz_c2: Any
    om_z: Any
    dx: float
    dy: float
    gb: tuple
    gt: tuple


def make_channel_metrics(setup):
    """Precompute the z-metric vectors by segmenting the ghosted grid
    arrays exactly as the slice graph does (`_convdiff_component`,
    ops/operators.py; reference src/operators.jl:647-690)."""
    g = setup.grid
    nz = g.Np[2]
    eps2 = 2 * float(np.finfo(setup.dtype).eps)

    delta = np.asarray(g.delta[2], np.float64)
    delta_u = np.asarray(g.delta_u[2], np.float64)

    def guard_inv(v):
        return np.where(v > eps2, 1.0 / np.maximum(v, eps2), 0.0)

    def pad0(v):
        """Pad an (nz-1,)-slot w-vector with 0 at the pinned slot."""
        return np.concatenate([v, [0.0]])

    # Tangential (box z ghosted 1..nz+1 -> slots 0..nz-1)
    inv_dz = 1.0 / delta[1 : nz + 1]
    inv_da_t = guard_inv(delta_u[0:nz])
    inv_db_t = guard_inv(delta_u[1 : nz + 1])

    # Normal (box z ghosted 1..nz -> slots 0..nz-2)
    inv_duz = pad0(1.0 / delta_u[1:nz])
    inv_da_n = pad0(guard_inv(delta[1:nz]))
    inv_db_n = pad0(guard_inv(delta[2 : nz + 1]))

    A1_t, A2_t = (np.asarray(v, np.float64) for v in g.A[0][2])
    A1b, A2b = (np.asarray(v, np.float64) for v in g.A[1][2])
    assert np.allclose(A1_t, A1b) and np.allclose(A2_t, A2b)
    az2 = pad0(A2_t[1:nz])  # seg(A2, box, 2)
    az1 = pad0(A1_t[2 : nz + 1])  # seg(A1, box, 2, +1)

    A1n, A2n = (np.asarray(v, np.float64) for v in g.A[2][2])
    azz_m2 = pad0(A2n[0 : nz - 1])  # seg(A2, box, 2, -1)
    azz_m1 = pad0(A1n[1:nz])  # seg(A1, box, 2, 0)
    azz_c2 = pad0(A2n[1:nz])  # seg(A2, box, 2, 0)
    azz_c1 = pad0(A1n[2 : nz + 1])  # seg(A1, box, 2, +1)

    # Uniform transverse spacings; on periodic-uniform x/y axes every
    # A-weight segment the stencil reads is exactly 1/2 (the endpoint
    # 1.0 entries of A[a][a] sit outside the DOF segments)
    dx = float(np.asarray(g.delta[0])[1])
    dy = float(np.asarray(g.delta[1])[1])
    # Tolerance scaled to the grid dtype: f32 linspace coordinates carry
    # ~eps*n relative jitter in the differences, so the weights sit near
    # (not exactly at) 0.5; the kernel uses the exact uniform value.
    eps = float(np.finfo(np.asarray(g.x[0]).dtype).eps)
    tol = max(1e-12, 64 * eps * max(g.N))
    for a in (0, 1):
        for b in range(3):
            A1, A2 = (np.asarray(v, np.float64) for v in g.A[b][a])
            assert np.allclose(A1[1:-1], 0.5, atol=tol), (a, b)
            assert np.allclose(A2[1:-1], 0.5, atol=tol), (a, b)

    om_z = delta[1 : nz + 1]

    bcl, bcr = setup.boundary_conditions[2]
    gb = _const_wall_values(bcl, 3, setup.dtype)
    gt = _const_wall_values(bcr, 3, setup.dtype)

    return ChannelMetrics(
        inv_dz=inv_dz, inv_da_t=inv_da_t, inv_db_t=inv_db_t,
        inv_duz=inv_duz, inv_da_n=inv_da_n, inv_db_n=inv_db_n,
        az1=az1, az2=az2,
        azz_m1=azz_m1, azz_m2=azz_m2, azz_c1=azz_c1, azz_c2=azz_c2,
        om_z=om_z, dx=dx, dy=dy, gb=gb, gt=gt,
    )


# --------------------------------------------------------------------------
# Roll-based operators on the interior layout
# --------------------------------------------------------------------------


def _rp(v, d):  # v[I + e_d], periodic wrap
    return jnp.roll(v, -1, axis=d)


def _rm(v, d):  # v[I - e_d]
    return jnp.roll(v, 1, axis=d)


def _zvec(v, dtype):
    return jnp.asarray(v, dtype).reshape(1, 1, -1)


def _masked_zshift(v, hi_ghost, lo_ghost, nz, dtype):
    """(v[z+1] with top ghost, v[z-1] with bottom ghost) for a
    cell-centered (tangential) field."""
    lane = jax.lax.broadcasted_iota(jnp.int32, v.shape, v.ndim - 1)
    vp = jnp.where(
        lane == nz - 1, jnp.asarray(hi_ghost, dtype), _rp(v, v.ndim - 1)
    )
    vm = jnp.where(lane == 0, jnp.asarray(lo_ghost, dtype), _rm(v, v.ndim - 1))
    return vp, vm


def channel_convdiff_roll(u, met, visc, dtype=None):
    """Fused convection+diffusion on the interior channel layout.
    Mirrors `_convdiff_component` restricted to the channel topology;
    returns F of the same shape (w's pinned slot gets F=0)."""
    dtype = dtype or u.dtype
    nz = u.shape[-1]
    dx = jnp.asarray(met.dx, dtype)
    dy = jnp.asarray(met.dy, dtype)
    visc = jnp.asarray(visc, dtype)
    zv = lambda v: _zvec(v, dtype)

    u0, u1, u2 = u[0], u[1], u[2]
    F = []

    # ---- tangential components a = 0, 1 --------------------------------
    for a in (0, 1):
        ua = u[a]
        t = (1 - a)  # the other tangential axis
        f = jnp.zeros_like(ua)
        # b = a (own axis, uniform): conv + diff
        ua_p = _rp(ua, a)
        ua_m = _rm(ua, a)
        phi2 = (0.5 * (ua + ua_p)) ** 2
        phi1 = (0.5 * (ua_m + ua)) ** 2
        da = dx if a == 0 else dy
        f = f - (phi2 - phi1) / da
        f = f + visc * (ua_p - 2.0 * ua + ua_m) / (da * da)
        # b = t (other tangential axis, uniform)
        ua_pt = _rp(ua, t)
        ua_mt = _rm(ua, t)
        ub = u[t]
        uab2 = 0.5 * (ua + ua_pt)
        uba2 = 0.5 * (ub + _rp(ub, a))
        phi2 = uab2 * uba2
        phi1 = _rm(phi2, t)
        db = dy if a == 0 else dx
        f = f - (phi2 - phi1) / db
        f = f + visc * (ua_pt - 2.0 * ua + ua_mt) / (db * db)
        # b = 2 (wall-normal, stretched)
        ua_zp, ua_zm = _masked_zshift(ua, met.gt[a], met.gb[a], nz, dtype)
        uab2 = 0.5 * (ua + ua_zp)
        uba2 = 0.5 * (u2 + _rp(u2, a))  # w interpolated to the a-face
        phi2 = uab2 * uba2
        # wrap of phi2 is the exact bottom-wall flux: slot nz-1 has
        # uba2 = 0 (pinned w), so phi2[nz-1] = 0 = wall flux
        phi1 = _rm(phi2, 2)
        f = f - (phi2 - phi1) * zv(met.inv_dz)
        d_hi = (ua_zp - ua) * zv(met.inv_db_t)
        d_lo = (ua - ua_zm) * zv(met.inv_da_t)
        f = f + visc * (d_hi - d_lo) * zv(met.inv_dz)
        F.append(f)

    # ---- normal component a = 2 ---------------------------------------
    w = u2
    f = jnp.zeros_like(w)
    for b in (0, 1):
        ub = u[b]
        w_pb = _rp(w, b)
        w_mb = _rm(w, b)
        uab2 = 0.5 * (w + w_pb)
        # u_b interpolated along z to the face (stretched weights)
        uba2 = zv(met.az2) * ub + zv(met.az1) * _rp(ub, 2)
        phi2 = uab2 * uba2
        phi1 = _rm(phi2, b)
        db = dx if b == 0 else dy
        f = f - (phi2 - phi1) / db
        f = f + visc * (w_pb - 2.0 * w + w_mb) / (db * db)
    # b = 2 (own axis): both fluxes computed directly — every z-roll of w
    # wraps the pinned slot as the correct 0 wall value
    w_zp = _rp(w, 2)
    w_zm = _rm(w, 2)
    uab2 = 0.5 * (w + w_zp)
    uab1 = 0.5 * (w_zm + w)
    uba2 = zv(met.azz_c2) * w + zv(met.azz_c1) * w_zp
    uba1 = zv(met.azz_m2) * w_zm + zv(met.azz_m1) * w
    f = f - (uab2 * uba2 - uab1 * uba1) * zv(met.inv_duz)
    d_hi = (w_zp - w) * zv(met.inv_db_n)
    d_lo = (w - w_zm) * zv(met.inv_da_n)
    f = f + visc * (d_hi - d_lo) * zv(met.inv_duz)
    # zero the pinned slot (inv_duz pad already zeros the b=2 terms; the
    # transverse terms vanish there because w's slot is 0, but the
    # diffusion of the pinned-zero plane does not — mask explicitly)
    lane = jax.lax.broadcasted_iota(jnp.int32, f.shape, f.ndim - 1)
    f = jnp.where(lane == nz - 1, jnp.zeros((), dtype), f)
    F.append(f)

    return jnp.stack(F)


def channel_divergence_roll(u, met):
    """Divergence at pressure points on the interior layout. w's z-roll
    wraps the pinned slot as the exact bottom-wall 0."""
    dtype = u.dtype
    return (
        (u[0] - _rm(u[0], 0)) / jnp.asarray(met.dx, dtype)
        + (u[1] - _rm(u[1], 1)) / jnp.asarray(met.dy, dtype)
        + (u[2] - _rm(u[2], 2)) * _zvec(met.inv_dz, dtype)
    )


def channel_correct_roll(u, q, met):
    """u - grad(q)/Delta_u (pressure correction). The w gradient divisor
    is 0-padded at the pinned slot, keeping it exactly 0."""
    dtype = u.dtype
    u0 = u[0] - (_rp(q, 0) - q) / jnp.asarray(met.dx, dtype)
    u1 = u[1] - (_rp(q, 1) - q) / jnp.asarray(met.dy, dtype)
    u2 = u[2] - (_rp(q, 2) - q) * _zvec(met.inv_duz, dtype)
    return jnp.stack([u0, u1, u2])


def channel_laplacian_box(q, setup):
    """Volume-scaled pressure Laplacian on the interior box via the
    BC-aware `lap_c` row coefficients (grid.py; reference
    src/operators.jl:328-352).  Periodic x/y rolls wrap correctly; the
    Dirichlet z rows have cl[0] = cr[-1] = 0, killing the wrapped
    values — no masks needed."""
    g = setup.grid
    dtype = q.dtype
    acc = 0.0
    for d in range(3):
        cl, cc, cr = (jnp.asarray(v, dtype) for v in g.lap_c[d])
        shape = [1, 1, 1]
        shape[d] = q.shape[d]
        cl, cc, cr = (jnp.reshape(v, shape) for v in (cl, cc, cr))
        delta_d = jnp.reshape(
            jnp.asarray(g.delta[d], dtype)[
                g.Ip[d][0] : g.Ip[d][1]
            ],
            shape,
        )
        part = cr * _rp(q, d) + cc * q + cl * _rm(q, d)
        acc = acc + part / delta_d
    om = _om_box(setup, dtype)
    return om * acc


def _om_box(setup, dtype):
    g = setup.grid
    om = 1.0
    for d in range(3):
        shape = [1, 1, 1]
        shape[d] = g.Np[d]
        om = om * jnp.reshape(
            jnp.asarray(g.delta[d], dtype)[g.Ip[d][0] : g.Ip[d][1]], shape
        )
    return om


# --------------------------------------------------------------------------
# Step driver
# --------------------------------------------------------------------------


def _interior_force(setup):
    """Steady body force on the interior layout (or None)."""
    if setup.bodyforce_field is not None:
        return strip_channel(setup.bodyforce_field)
    return None


def make_channel_timestep(setup, method, *, nrefine=None):
    """Build `step(state, dt, theta) -> state` on the interior channel
    layout (see module docs).  Classic-row explicit RK only (the
    default RK44 and friends).

    ``nrefine``: iterative-refinement sweeps of the FDM projection
    (default: 0 unless the working-dtype transforms are ill-conditioned
    enough to lose the CG tolerance).
    """
    assert channelpath_applicable(setup, method)
    from .fdm import fdm_solve_box, fdm_transform_roundoff

    dtype = setup.dtype
    met = make_channel_metrics(setup)
    visc = float(1.0 / np.asarray(setup.Re))
    if nrefine is None:
        # The projection only needs CG-tolerance accuracy (reference
        # reltol 1e-4, src/pressure.jl:209-215); refine only when the
        # working-dtype eigen transforms are poorly conditioned enough
        # to lose that (measured: tanh-1.2 at nz=128 leaves the SAME
        # post-projection divergence with 0 sweeps as with 1).
        nrefine = 1 if fdm_transform_roundoff(setup) > 1e-4 else 0
    # Full-f32 contractions (see fdm_solve_box): measured on an H100,
    # TF32 left 8.4e-4 of the divergence on the 256x128x128 channel,
    # above the CG tolerance cited above; HIGHEST left 1.2e-6
    solve_box = fdm_solve_box(setup)
    om = _om_box(setup, dtype)
    force = _interior_force(setup)
    A, ns = method.A, method.nstage

    def psolve(div):
        """Projection potential q from the interior divergence."""
        f = om * div
        q = solve_box(f)
        for _ in range(nrefine):
            r = f - channel_laplacian_box(q, setup)
            q = q + solve_box(r)
        return q

    def step_roll(state, dt, theta):
        u, _, t, n = state
        ustart = u
        acc = ustart
        for i in range(ns):
            last = i == ns - 1
            k = channel_convdiff_roll(u, met, visc)
            if force is not None:
                k = k + force
            b = A[ns - 1][i]
            if b != 0.0:
                acc = acc + (dt * b) * k
            target = acc if last else ustart + (dt * A[i][i]) * k
            q = psolve(channel_divergence_roll(target, met))
            u = channel_correct_roll(target, q, met)
        return state._replace(u=u, t=state.t + dt, n=state.n + 1)

    return step_roll
