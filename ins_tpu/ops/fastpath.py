"""Ghost-free fast path for uniform periodic grids.

The reference carries ghost cells on every field and refills them around
each operator (src/operators.jl:13-33) — an artifact of its kernel model.
On a uniform periodic grid the formulation here drops the ghost layer
entirely: every stencil shift is a circular `jnp.roll` on the interior
field (which XLA fuses into loop kernels and, under a sharded mesh,
lowers to collective-permutes), there are no BC fills, no scatters and
no padding in the hot loop, and the pressure projection is one real FFT
pair (cuFFT on the GPU).

`solve_unsteady` dispatches here automatically when the setup qualifies;
states cross the boundary via strip (drop ghosts) / reghost (periodic
wrap pad, which *is* the periodic BC fill).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..time_steppers.methods import ExplicitRungeKuttaMethod, LMWray3
from ..time_steppers.step import StepperState
from .pressure import spectral_inverse_laplacian

__all__ = [
    "fastpath_applicable",
    "strip_ghosts",
    "reghost",
    "strip_scalar",
    "reghost_scalar",
    "strip_state",
    "reghost_state",
    "convdiff_roll",
    "make_fast_timestep",
]


def fastpath_applicable(setup, method, psolver):
    """Fast path requires: 2D/3D uniform periodic grid, an explicit RK /
    LMWray3 method, the spectral pressure solver, and — if a Boussinesq
    temperature equation is attached — periodic temperature BCs (the
    temperature then rides the same roll graph, incl. the dissipation
    term; reference treats the temperature RHS as first-class in the hot
    loop, src/time_steppers/step_explicit_runge_kutta.jl:20-28)."""
    g = setup.grid
    tq = setup.temperature
    temp_ok = tq is None or all(
        type(b).__name__ == "PeriodicBC"
        for bcs in tq.boundary_conditions
        for b in bcs
    )
    return (
        all(g.periodic)
        and all(g.uniform)
        and temp_ok
        and isinstance(method, (ExplicitRungeKuttaMethod, LMWray3))
        and getattr(psolver, "is_spectral", False)
    )


def strip_ghosts(u):
    D = u.ndim - 1
    return u[(slice(None),) + (slice(1, -1),) * D]


def reghost(u_int):
    """Periodic wrap pad == the periodic ghost fill."""
    D = u_int.ndim - 1
    return jnp.pad(u_int, ((0, 0),) + ((1, 1),) * D, mode="wrap")


def strip_scalar(s):
    return s[(slice(1, -1),) * s.ndim]


def reghost_scalar(s_int):
    return jnp.pad(s_int, ((1, 1),) * s_int.ndim, mode="wrap")


def strip_state(state):
    """Public (ghosted) -> fast-path (interior) state layout."""
    state = state._replace(u=strip_ghosts(state.u))
    if state.temp is not None:
        state = state._replace(temp=strip_scalar(state.temp))
    return state


def reghost_state(state):
    """Fast-path (interior) -> public (ghosted) state layout."""
    state = state._replace(u=reghost(state.u))
    if state.temp is not None:
        state = state._replace(temp=reghost_scalar(state.temp))
    return state


def _roll_p(v, d):  # v[I + e_d]
    return jnp.roll(v, -1, axis=d)


def _roll_m(v, d):  # v[I - e_d]
    return jnp.roll(v, 1, axis=d)


def convdiff_roll(u, visc, dxs):
    """Convection + diffusion on ghost-free periodic-uniform interior
    fields (any D) as a pure roll graph (reference
    convectiondiffusion!, src/operators.jl:590-680, uniform periodic
    case where all interpolation weights are 1/2)."""
    D = u.shape[0]
    F = []
    for a in range(D):
        ua = u[a]
        f = 0.0
        for b in range(D):
            upb, umb = _roll_p(ua, b), _roll_m(ua, b)
            f = f + (visc / dxs[b] ** 2) * (upb - 2.0 * ua + umb)
            uab1 = 0.5 * (umb + ua)
            uab2 = 0.5 * (ua + upb)
            if a == b:
                uba1, uba2 = uab1, uab2
            else:
                ub = u[b]
                ub_pa = _roll_p(ub, a)
                uba1 = 0.5 * (_roll_m(ub, b) + _roll_m(ub_pa, b))
                uba2 = 0.5 * (ub + ub_pa)
            f = f - (uab2 * uba2 - uab1 * uba1) / dxs[b]
        F.append(f)
    return jnp.stack(F)


def make_fast_timestep(setup, method):
    """Build `step(state, dt, theta) -> state` on interior-layout velocity.

    Reproduces the math of the ghosted ERK/LMWray3 steppers (which mirror
    reference step_explicit_runge_kutta.jl / step_lmwray3.jl) for the
    periodic-uniform case where all interpolation weights are 1/2.  The
    step is plain `jax.numpy`, so it is reverse-mode differentiable as it
    stands (a-posteriori training unrolls step through it).
    """
    g = setup.grid
    D = g.dim
    Np = tuple(int(n) for n in g.Np)
    dxs = tuple(float(np.asarray(g.delta[d])[0]) for d in range(D))
    vol = float(np.prod(dxs))
    visc = 1 / setup.Re

    bodyforce_int = (
        strip_ghosts(setup.bodyforce_field)
        if setup.bodyforce_field is not None
        else None
    )

    # Boussinesq temperature (periodic BCs — checked by
    # `fastpath_applicable`): buoyancy in the momentum, temperature
    # convection-diffusion (+ optional dissipation) advanced with the
    # same tableau.  Reference: src/operators.jl:711-808, 916-931.
    tq = setup.temperature
    if tq is not None:
        gdir = tq.gdir
        alpha2 = float(np.asarray(tq.alpha2))
        alpha4 = float(np.asarray(tq.alpha4))
        dis_coef = (
            float(np.asarray(setup.Re * tq.alpha1 / tq.gamma))
            if tq.dodissipation
            else None
        )
    # A natural-form Smagorinsky closure (tagged by
    # `smagorinsky_closure_natural`) runs as its ghost-free twin
    # `smagorinsky_natural_interior`; untagged closures stay on the
    # ghosted round trip.
    _smag = getattr(setup.closure_model, "kind", None) == "smagorinsky_natural"

    def momentum(u, temp, t, theta):
        F = convdiff_roll(u, visc, dxs)
        if temp is not None:
            tavg = 0.5 * (temp + _roll_p(temp, gdir))
            F = F.at[gdir].add(alpha2 * tavg)
        if bodyforce_int is not None:
            F = F + bodyforce_int
        elif setup.bodyforce is not None:
            full = tuple((0, n) for n in g.N)
            from ._stencil import seg

            comps = []
            for a in range(D):
                coords = tuple(seg(g.xu[a][b], full, b) for b in range(D))
                comps.append(
                    setup.bodyforce(a, *coords, t) * jnp.ones(g.N, setup.dtype)
                )
            F = F + strip_ghosts(jnp.stack(comps))
        if _smag:
            from .eddyviscosity import smagorinsky_natural_interior

            F = F + smagorinsky_natural_interior(u, theta, dxs)
        elif setup.closure_model is not None:
            # Untagged closure models take the ghosted solver layout
            F = F + strip_ghosts(setup.closure_model(reghost(u), theta))
        return F

    def temp_rhs(u, temp):
        """Temperature convection-diffusion (+ optional dissipation) on
        the periodic-uniform interior layout (roll twin of
        operators.convection_diffusion_temp / dissipation)."""
        acc = 0.0
        for b in range(D):
            T_pb, T_mb = _roll_p(temp, b), _roll_m(temp, b)
            ub = u[b]
            uT2 = ub * 0.5 * (temp + T_pb)
            uT1 = _roll_m(ub, b) * 0.5 * (T_mb + temp)
            dT2 = (T_pb - temp) / dxs[b]
            dT1 = (temp - T_mb) / dxs[b]
            acc = acc + (-(uT2 - uT1) + alpha4 * (dT2 - dT1)) / dxs[b]
        if dis_coef is not None:
            dacc = 0.0
            for b in range(D):
                ub = u[b]
                diffb = sum(
                    (visc / dxs[c] ** 2)
                    * (_roll_p(ub, c) - 2.0 * ub + _roll_m(ub, c))
                    for c in range(D)
                )
                dacc = dacc + (
                    _roll_m(ub, b) * _roll_m(diffb, b) + ub * diffb
                ) / 2
            acc = acc + dis_coef * dacc
        return acc

    def project(u):
        div = sum((u[a] - _roll_m(u[a], a)) / dxs[a] for a in range(D)) * vol
        inv_denom = spectral_inverse_laplacian(Np, dxs, setup.dtype)
        ph = jnp.fft.rfftn(div) * inv_denom
        p = jnp.fft.irfftn(ph, div.shape).astype(setup.dtype)
        G = jnp.stack([(_roll_p(p, a) - p) / dxs[a] for a in range(D)])
        return u - G

    if isinstance(method, ExplicitRungeKuttaMethod):
        A, c, ns = method.A, method.c, method.nstage

        def step(state, dt, theta):
            u, temp, t, n = state
            tstart = t
            ustart = u
            tempstart = temp
            ku, kt = [], []
            for i in range(ns):
                ku.append(momentum(u, temp, t, theta))
                if temp is not None:
                    kt.append(temp_rhs(u, temp))
                t = tstart + c[i] * dt
                # ustart + dt * sum_j A[i][j] k_j: an axpy chain XLA
                # fuses into the divergence's loop kernel
                u = ustart
                for j in range(i + 1):
                    if A[i][j] != 0.0:
                        u = u + (dt * A[i][j]) * ku[j]
                u = project(u)
                if temp is not None:
                    temp = tempstart
                    for j in range(i + 1):
                        if A[i][j] != 0.0:
                            temp = temp + (dt * A[i][j]) * kt[j]
            return StepperState(u=u, temp=temp, t=t, n=n + 1)

    else:  # LMWray3
        a_, b_, c_ = method.a, method.b, method.c
        ns = len(a_)

        def step(state, dt, theta):
            u, temp, t, n = state
            tstart = t
            ustart = u
            tempstart = temp
            for i in range(ns):
                ti = tstart + c_[i] * dt
                du = momentum(u, temp, ti, theta)
                dtemp = temp_rhs(u, temp) if temp is not None else None
                u = project(ustart + dt * a_[i] * du)
                if temp is not None:
                    temp = tempstart + dt * a_[i] * dtemp
                if i < ns - 1:
                    ustart = ustart + dt * b_[i] * du
                    if temp is not None:
                        tempstart = tempstart + dt * b_[i] * dtemp
            return StepperState(u=u, temp=temp, t=tstart + dt, n=n + 1)

    return step
