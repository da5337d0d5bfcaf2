"""Hand-rolled multi-device stepping: shard_map + explicit collectives.

The GSPMD path (`solve_unsteady(mesh=...)`) lets XLA insert collectives.
This module is the explicitly-scheduled alternative for the periodic
uniform fast path (SURVEY.md §2.5, items a-c):

- **x-slab (1-D mesh) or x/y-pencil (2-D mesh) domain decomposition** of
  the ghost-free interior fields;
- **halo exchange** of boundary planes with `lax.ppermute` ring shifts
  along every sharded axis (x first, then y, so corner halos ride along
  correctly), replacing the reference's ghost reads at shard edges;
- **pressure solve** either by a **pencil-decomposed FFT** (local FFTs
  over unsharded axes, `lax.all_to_all` transposes to localize each
  sharded axis in turn) or by **matrix-free CG whose reductions are
  `lax.psum` over the mesh**;
- optional **Boussinesq temperature** coupling (periodic BCs), a steady
  **body force**, and the natural-form **Smagorinsky closure**, advanced
  with the same tableau as the single-device fast path.

Everything runs inside one `shard_map`, so the collective schedule is
explicit (NCCL carries the ppermutes and all_to_alls on GPUs).  Per-shard
stencils are the fast path's shift graph on halo-padded local blocks.
Reference counterpart: none (single-device); capability target per
BASELINE.json "weak-scaling linearly".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..time_steppers.methods import ExplicitRungeKuttaMethod, LMWray3
from ..time_steppers.step import StepperState

__all__ = ["make_halo_fast_step", "shard_interior", "shard_scalar"]

AXIS = "x"
AXIS_Y = "y"


def _specs(mesh, ndim_field):
    """PartitionSpec over the spatial dims for a (D, nx, ny[, nz]) field."""
    names = mesh.axis_names
    sp = [None] * ndim_field
    sp[1] = AXIS
    if AXIS_Y in names:
        sp[2] = AXIS_Y
    return P(*sp)


def shard_interior(mesh, u_int):
    """Place a ghost-free interior field (D, nx, ny[, nz]) with spatial
    dim 0 sharded over 'x' (and dim 1 over 'y' on a 2-D mesh)."""
    return jax.device_put(u_int, NamedSharding(mesh, _specs(mesh, u_int.ndim)))


def shard_scalar(mesh, s_int):
    """Place a scalar interior field (nx, ny[, nz]) like the velocity."""
    names = mesh.axis_names
    sp = [None] * s_int.ndim
    sp[0] = AXIS
    if AXIS_Y in names:
        sp[1] = AXIS_Y
    return jax.device_put(s_int, NamedSharding(mesh, P(*sp)))


def _halo_pad(v, dim, axis_name, nshards, lo=1, hi=1):
    """Pad `dim` of a per-device block with `lo` planes from the left
    ring neighbour and `hi` from the right (periodic)."""
    right_perm = [(i, (i + 1) % nshards) for i in range(nshards)]
    left_perm = [(i, (i - 1) % nshards) for i in range(nshards)]
    parts = []
    if lo:
        last = jax.lax.slice_in_dim(
            v, v.shape[dim] - lo, v.shape[dim], axis=dim
        )
        parts.append(jax.lax.ppermute(last, axis_name, right_perm))
    parts.append(v)
    if hi:
        first = jax.lax.slice_in_dim(v, 0, hi, axis=dim)
        parts.append(jax.lax.ppermute(first, axis_name, left_perm))
    return jnp.concatenate(parts, axis=dim)


def make_halo_fast_step(setup, method, mesh, *, psolver="pencil",
                        donate=False, cg_maxiter=None, cg_reltol=None):
    """Build `step(state, dt, theta=None) -> state` for a 3D uniform
    periodic setup on x-slab (1-D mesh `("x",)`) or x/y-pencil (2-D mesh
    `("x", "y")`) sharded interior fields.

    `psolver`: "pencil" (all_to_all transposed FFT Poisson solve) or
    "cg" (matrix-free CG with psum-reduced inner products).
    `donate=False` (default) keeps the input state alive;
    `donate=True` donates `state.u`/`state.temp` for in-place stepping
    (do not reuse a state you stepped from).

    The returned `step` also carries `step.raw(state, dt, theta)` — the
    un-jitted shard_map'd step — so a driver can trace it inside its own
    jit/scan without nested-donation loss
    (`solver.solve_unsteady(halo=True)`)."""
    g = setup.grid
    D = g.dim
    assert D == 3, "halo fast path: 3D"
    assert all(g.periodic) and all(g.uniform)
    assert isinstance(method, (ExplicitRungeKuttaMethod, LMWray3)), method
    names = mesh.axis_names
    assert names[0] == AXIS
    has_y = AXIS_Y in names
    mx = mesh.shape[AXIS]
    my = mesh.shape[AXIS_Y] if has_y else 1
    nx, ny, nz = tuple(g.Np)
    assert nx % mx == 0 and ny % my == 0
    lx, ly = nx // mx, ny // my
    dxs = tuple(float(np.asarray(g.delta[d])[0]) for d in range(D))
    vol = float(np.prod(dxs))
    dtype = setup.dtype

    tq = setup.temperature
    if tq is not None:
        assert all(
            type(b).__name__ == "PeriodicBC"
            for bcs in tq.boundary_conditions
            for b in bcs
        ), "halo fast path: periodic temperature BCs only"
        gdir = tq.gdir
        alpha2 = float(np.asarray(tq.alpha2))
        alpha4 = float(np.asarray(tq.alpha4))
        dis_coef = (
            float(np.asarray(setup.Re * tq.alpha1 / tq.gamma))
            if tq.dodissipation
            else None
        )

    # Steady body force: the interior field rides as an explicit sharded
    # shard_map input (NOT a closure constant, which GSPMD would
    # replicate per device).  Unsteady callable forces are not supported
    # on the halo path.
    if setup.bodyforce is not None and setup.bodyforce_field is None:
        raise ValueError(
            "halo fast path: unsteady callable body forces are not "
            "supported; precompute a steady field (issteadybodyforce)"
        )
    bf_int = None
    if setup.bodyforce_field is not None:
        bf_int = setup.bodyforce_field[(slice(None),) + (slice(1, -1),) * 3]
        bf_int = shard_interior(mesh, bf_int)

    # Closure: only the natural-form Smagorinsky (tagged) runs here, as
    # its roll twin on a 3-plane halo-padded block.
    _smag = (
        getattr(setup.closure_model, "kind", None) == "smagorinsky_natural"
    )
    if setup.closure_model is not None and not _smag:
        raise ValueError(
            "halo fast path: only the tagged natural-form Smagorinsky "
            "closure is supported (smagorinsky_closure_natural)"
        )
    if _smag and (lx < 3 or (has_y and ly < 3)):
        raise ValueError(
            "halo fast path: the Smagorinsky closure needs at least 3 "
            "planes per shard along each sharded axis"
        )

    def pad_all(v, dims, lo=1, hi=1):
        """Halo-pad spatial dims of a local block; x before y so the
        y-exchange carries the x-halo columns (correct corners)."""
        if 0 in dims:
            v = _halo_pad(v, v.ndim - 3, AXIS, mx, lo, hi)
        if 1 in dims and has_y:
            v = _halo_pad(v, v.ndim - 2, AXIS_Y, my, lo, hi)
        return v

    def shift(v, sx, sy, sz):
        """Shift accessor on an x-(and, on 2-D meshes, y-)padded block."""
        v = v[1 + sx : 1 + sx + lx]
        if has_y:
            v = v[:, 1 + sy : 1 + sy + ly]
        elif sy:
            v = jnp.roll(v, -sy, axis=1)
        if sz:
            v = jnp.roll(v, -sz, axis=2)
        return v

    e = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]

    def smag_force_local(u, theta):
        """Per-shard natural Smagorinsky force: the roll twin
        `smagorinsky_natural_interior` on a block padded by its stencil
        reach (3 planes) along each sharded axis; the wrapped edge planes
        are discarded."""
        from ..ops.eddyviscosity import smagorinsky_natural_interior

        f = smagorinsky_natural_interior(pad_all(u, (0, 1), 3, 3), theta, dxs)
        f = f[:, 3:-3]
        return f[:, :, 3:-3] if has_y else f

    def convdiff_local(u):
        visc = 1 / setup.Re
        up = [pad_all(u[a], (0, 1)) for a in range(3)]
        F = []
        for a in range(3):
            u_c = shift(up[a], 0, 0, 0)
            f = jnp.zeros_like(u_c)
            for b in range(3):
                sb = e[b]
                u_pb = shift(up[a], *sb)
                u_mb = shift(up[a], *(-s for s in sb))
                f += (visc / dxs[b] ** 2) * (u_pb - 2.0 * u_c + u_mb)
                uab1 = 0.5 * (u_mb + u_c)
                uab2 = 0.5 * (u_c + u_pb)
                if a == b:
                    uba1, uba2 = uab1, uab2
                else:
                    sa = e[a]
                    ub_c = shift(up[b], 0, 0, 0)
                    ub_pa = shift(up[b], *sa)
                    ub_mb = shift(up[b], *(-s for s in sb))
                    ub_mb_pa = shift(up[b], *(x - y for x, y in zip(sa, sb)))
                    uba1 = 0.5 * (ub_mb + ub_mb_pa)
                    uba2 = 0.5 * (ub_c + ub_pa)
                f -= (uab2 * uba2 - uab1 * uba1) / dxs[b]
            F.append(f)
        return jnp.stack(F)

    def buoyancy_force(temp):
        """alpha2 * face-averaged temperature on the gravity component
        (reference applybodyforce! temperature term,
        src/operators.jl:916-931)."""
        if gdir == 0:
            tp = _halo_pad(temp, 0, AXIS, mx, 0, 1)
            tavg = 0.5 * (tp[:-1] + tp[1:])
        elif gdir == 1 and has_y:
            tp = _halo_pad(temp, 1, AXIS_Y, my, 0, 1)
            tavg = 0.5 * (tp[:, :-1] + tp[:, 1:])
        else:
            tavg = 0.5 * (temp + jnp.roll(temp, -1, axis=gdir))
        return tavg

    def force_stream(u, temp, theta, bf):
        """Per-stage extra force: steady body force + buoyancy +
        Smagorinsky, combined into one (3, lx, ly, nz) stream (or None).
        Part of the momentum RHS k."""
        out = None
        if _smag:
            out = smag_force_local(u, theta)
            if bf is not None:
                out = out + bf
        elif bf is not None:
            out = bf
        if temp is not None:
            b = alpha2 * buoyancy_force(temp)
            if out is None:
                out = jnp.zeros((3,) + u.shape[1:], u.dtype).at[gdir].set(b)
            else:
                out = out.at[gdir].add(b)
        return out

    def momentum_local(u, temp, theta, bf):
        F = convdiff_local(u)
        fs = force_stream(u, temp, theta, bf)
        return F if fs is None else F + fs

    def temp_rhs_local(u, temp):
        """Temperature convection-diffusion (+ optional dissipation) on
        the local block (uniform periodic form of
        operators.convection_diffusion_temp / dissipation)."""
        tp = pad_all(temp, (0, 1))
        up = [pad_all(u[b], (0, 1)) for b in range(3)]
        T = shift(tp, 0, 0, 0)
        acc = jnp.zeros_like(T)
        for b in range(3):
            sb = e[b]
            T_pb = shift(tp, *sb)
            T_mb = shift(tp, *(-s for s in sb))
            ub_c = shift(up[b], 0, 0, 0)
            ub_m = shift(up[b], *(-s for s in sb))
            dT1 = (T - T_mb) / dxs[b]
            dT2 = (T_pb - T) / dxs[b]
            uT1 = ub_m * 0.5 * (T_mb + T)
            uT2 = ub_c * 0.5 * (T + T_pb)
            acc += (-(uT2 - uT1) + alpha4 * (dT2 - dT1)) / dxs[b]
        if dis_coef is not None:
            # u.diffusion(u) interpolated to pressure points; the
            # diffusion eval needs a 2-wide halo, obtained by computing
            # it on the 1-halo'd block and re-padding the result.
            visc = 1 / setup.Re
            dacc = jnp.zeros_like(T)
            for b in range(3):
                sb = e[b]
                diffb = jnp.zeros_like(T)
                for cdim in range(3):
                    sc = e[cdim]
                    diffb += (visc / dxs[cdim] ** 2) * (
                        shift(up[b], *sc)
                        - 2.0 * shift(up[b], 0, 0, 0)
                        + shift(up[b], *(-s for s in sc))
                    )
                dp = pad_all(diffb, (0, 1))
                ub_c = shift(up[b], 0, 0, 0)
                ub_m = shift(up[b], *(-s for s in sb))
                dacc += (
                    ub_m * shift(dp, *(-s for s in sb))
                    + ub_c * shift(dp, 0, 0, 0)
                ) / 2
            acc += dis_coef * dacc
        return acc

    # ---------------- pressure solves ----------------
    nzh = nz // 2 + 1

    def _lam(d, size):
        """Per-axis eigenvalues 4 vol sin^2(pi k / n_d) / dx_d^2 of the
        volume-scaled Laplacian, k < size (1-D constant)."""
        n = (nx, ny, nz)[d]
        k = np.arange(size)
        return jnp.asarray(
            4 * vol * np.sin(np.pi * k / n) ** 2 / dxs[d] ** 2, dtype
        )

    def _inv_scale(lam_x, lam_y, lam_z):
        """This shard's block of the inverse-Laplacian multiplier, built
        in-graph from 1-D eigenvalue slices (no n^3 constant); the
        zero-mean mode (den == 0) is pinned to 0."""
        den = lam_x[:, None, None] + lam_y[None, :, None] + lam_z[None, None, :]
        return jnp.where(den == 0, 0.0, -1.0 / jnp.where(den == 0, 1.0, den))

    if psolver == "pencil" and not has_y:
        ly_loc = ny // mx

        def poisson_local(div):
            """x-slab pencil rFFT: rfft z + fft y locally, all_to_all to
            localize x, fft x, scale, inverse chain."""
            idx = jax.lax.axis_index(AXIS)
            fh = jnp.fft.rfft(div, axis=2)
            fh = jnp.fft.fft(fh, axis=1)
            fh = jax.lax.all_to_all(
                fh, AXIS, split_axis=1, concat_axis=0, tiled=True
            )
            fh = jnp.fft.fft(fh, axis=0)
            scale = _inv_scale(
                _lam(0, nx),
                jax.lax.dynamic_slice_in_dim(
                    _lam(1, ny), idx * ly_loc, ly_loc
                ),
                _lam(2, nzh),
            )
            fh = fh * scale.astype(fh.dtype)
            fh = jnp.fft.ifft(fh, axis=0)
            fh = jax.lax.all_to_all(
                fh, AXIS, split_axis=0, concat_axis=1, tiled=True
            )
            fh = jnp.fft.ifft(fh, axis=1)
            return jnp.fft.irfft(fh, nz, axis=2).astype(div.dtype)

    elif psolver == "pencil":
        assert nz % my == 0 and ny % mx == 0, (
            "2-D pencil FFT needs nz % my == 0 and ny % mx == 0"
        )
        lyx = ny // mx  # y-block per x-shard after the x transpose
        lzy = nz // my  # z-block per y-shard after the y transpose

        def poisson_local(div):
            """x/y-pencil complex FFT: fft z locally; all_to_all over 'y'
            (z <-> y swap) then fft y; all_to_all over 'x' (y <-> x swap)
            then fft x; scale; inverse chain."""
            ix = jax.lax.axis_index(AXIS)
            iy = jax.lax.axis_index(AXIS_Y)
            fh = jnp.fft.fft(div.astype(
                jnp.complex64 if dtype == jnp.float32 else jnp.complex128
            ), axis=2)  # (lx, ly, nz)
            fh = jax.lax.all_to_all(
                fh, AXIS_Y, split_axis=2, concat_axis=1, tiled=True
            )  # (lx, ny, lzy)
            fh = jnp.fft.fft(fh, axis=1)
            fh = jax.lax.all_to_all(
                fh, AXIS, split_axis=1, concat_axis=0, tiled=True
            )  # (nx, lyx, lzy)
            fh = jnp.fft.fft(fh, axis=0)
            scale = _inv_scale(
                _lam(0, nx),
                jax.lax.dynamic_slice_in_dim(_lam(1, ny), ix * lyx, lyx),
                jax.lax.dynamic_slice_in_dim(_lam(2, nz), iy * lzy, lzy),
            )
            fh = fh * scale.astype(fh.dtype)
            fh = jnp.fft.ifft(fh, axis=0)
            fh = jax.lax.all_to_all(
                fh, AXIS, split_axis=0, concat_axis=1, tiled=True
            )
            fh = jnp.fft.ifft(fh, axis=1)
            fh = jax.lax.all_to_all(
                fh, AXIS_Y, split_axis=1, concat_axis=2, tiled=True
            )
            return jnp.fft.ifft(fh, axis=2).real.astype(div.dtype)

    elif psolver == "cg":
        if cg_reltol is None:
            cg_reltol = float(np.sqrt(np.finfo(np.dtype(dtype)).eps))
        if cg_maxiter is None:
            cg_maxiter = nx * ny
        npoints = float(nx * ny * nz)
        diag = sum(-2.0 * vol / dxs[b] ** 2 for b in range(3))

        def psum_all(x):
            x = jax.lax.psum(x, AXIS)
            if has_y:
                x = jax.lax.psum(x, AXIS_Y)
            return x

        def lap_local(p):
            pp = pad_all(p, (0, 1))
            pc = shift(pp, 0, 0, 0)
            out = jnp.zeros_like(pc)
            for b in range(3):
                sb = e[b]
                out += (
                    shift(pp, *sb) - 2.0 * pc + shift(pp, *(-s for s in sb))
                ) * (vol / dxs[b] ** 2)
            return out

        def poisson_local(f):
            """Matrix-free Jacobi-CG; every reduction is a psum over the
            mesh so all shards agree on alpha/beta/termination."""
            f = f - psum_all(jnp.sum(f)) / npoints  # nullspace projection

            def inner(a, b):
                return psum_all(jnp.sum(a * b))

            r = f
            res0 = jnp.sqrt(inner(r, r))
            tol = cg_reltol * res0
            x = jnp.zeros_like(f)
            q = jnp.zeros_like(f)
            state = (x, r, q, jnp.asarray(1.0, dtype), res0, 0)

            def cond(s):
                *_, res, it = s
                return jnp.logical_and(it < cg_maxiter, res > tol)

            def body(s):
                x, r, q, rho_prev, res, it = s
                z = r / diag
                rho = inner(z, r)
                beta = rho / rho_prev
                q = z + beta * q
                Lq = lap_local(q)
                alpha = rho / inner(q, Lq)
                x = x + alpha * q
                r = r - alpha * Lq
                return (x, r, q, rho, jnp.sqrt(inner(r, r)), it + 1)

            x, *_ = jax.lax.while_loop(cond, body, state)
            return x - psum_all(jnp.sum(x)) / npoints

    else:
        raise ValueError(f"unknown halo psolver {psolver!r}")

    def project_local(u):
        up = [pad_all(u[a], (0, 1)) for a in range(3)]
        div = sum(
            (shift(up[a], 0, 0, 0) - shift(up[a], *(-s for s in e[a])))
            / dxs[a]
            for a in range(3)
        ) * vol
        p = poisson_local(div)
        pp = pad_all(p, (0, 1))
        G = jnp.stack(
            [(shift(pp, *e[a]) - shift(pp, 0, 0, 0)) / dxs[a]
             for a in range(3)]
        )
        return u - G

    # ---------------- steppers ----------------
    if isinstance(method, ExplicitRungeKuttaMethod):
        A, ns = method.A, method.nstage

        def step_local(u, temp, dt, theta, bf):
            ustart, tstart_ = u, temp
            ku, kt = [], []
            for i in range(ns):
                ku.append(momentum_local(u, temp, theta, bf))
                if temp is not None:
                    kt.append(temp_rhs_local(u, temp))
                u = ustart
                for j in range(i + 1):
                    if A[i][j] != 0.0:
                        u = u + dt * A[i][j] * ku[j]
                u = project_local(u)
                if temp is not None:
                    temp = tstart_
                    for j in range(i + 1):
                        if A[i][j] != 0.0:
                            temp = temp + dt * A[i][j] * kt[j]
            return u, temp

    else:  # LMWray3
        a_, b_ = method.a, method.b
        ns = len(a_)

        def step_local(u, temp, dt, theta, bf):
            ustart = u
            tempstart = temp
            for i in range(ns):
                du = momentum_local(u, temp, theta, bf)
                dtemp = temp_rhs_local(u, temp) if temp is not None else None
                u = project_local(ustart + dt * a_[i] * du)
                if temp is not None:
                    temp = tempstart + dt * a_[i] * dtemp
                if i < ns - 1:
                    ustart = ustart + dt * b_[i] * du
                    if temp is not None:
                        tempstart = tempstart + dt * b_[i] * dtemp
            return u, temp

    uspec = _specs(mesh, 4)
    names_s = [AXIS, AXIS_Y] if has_y else [AXIS]
    sspec = P(*names_s, *([None] * (3 - len(names_s))))

    with_temp = tq is not None
    with_bf = bf_int is not None

    def _stepl(*args):
        it = iter(args)
        u = next(it)
        temp = next(it) if with_temp else None
        bf = next(it) if with_bf else None
        dt = next(it)
        theta = next(it)
        un, tn = step_local(u, temp, dt, theta, bf)
        return (un, tn) if with_temp else un

    in_specs = (
        (uspec,)
        + ((sspec,) if with_temp else ())
        + ((uspec,) if with_bf else ())
        + (P(), P())
    )
    out_specs = (uspec, sspec) if with_temp else uspec

    raw = jax.shard_map(
        _stepl, mesh=mesh, in_specs=in_specs, out_specs=out_specs
    )
    dargs = ()
    if donate:
        dargs = (0, 1) if with_temp else (0,)
    step_sharded = jax.jit(raw, donate_argnums=dargs)

    def _call(fn, state, dt, theta):
        dtj = jnp.asarray(dt, dtype)
        thj = jnp.asarray(0.0 if theta is None else theta, dtype)
        args = (state.u,)
        if with_temp:
            args += (state.temp,)
        if with_bf:
            args += (bf_int,)
        out = fn(*args, dtj, thj)
        u, temp = out if with_temp else (out, None)
        return StepperState(u=u, temp=temp, t=state.t + dt, n=state.n + 1)

    def step(state, dt, theta=None):
        return _call(step_sharded, state, dt, theta)

    # Driver hook (`solve_unsteady(halo=True)`): trace the un-jitted
    # shard_map inside the driver's own jit/scan.
    step.raw = lambda state, dt, theta=None: _call(raw, state, dt, theta)
    return step
