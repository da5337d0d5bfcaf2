"""IMEX Adams-Bashforth/Crank-Nicolson and one-leg steppers.

Functional ports of the *math* of IncompressibleNavierStokes.jl
`src/time_steppers/step_ab_cn.jl` and `step_one_leg.jl` (the reference
versions are written against its removed v1 API and are not callable;
the governing equations are specified in methods.jl:6-132). The implicit
diffusion solve runs as matrix-free CG under jit (on device, instead of
the reference's cached host LU).

Startup: both methods need one step of history. Like the reference
(methods.jl:74-132 `method_startup`; step_one_leg.jl:18-30), the first
step is taken with a one-step startup method (default RK44) under a
`lax.cond` on the step counter, which restores full order from step one;
passing `method_startup=False` keeps the cheap first-order
`u_{-1} = u_0` startup.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..boundary_conditions import apply_bc_p, apply_bc_u
from ..ops._stencil import slc
from ..ops.operators import (
    applybodyforce,
    convection,
    diffusion,
    divergence,
    momentum,
    pressuregradient,
    scalewithvolume,
)
from ..ops.pressure import poisson, pressure

__all__ = ["ABCNState", "OneLegState"]


class ABCNState(NamedTuple):
    u: Any
    temp: Any
    t: Any
    n: Any
    c_prev: Any  # convection term at previous step
    p: Any  # pressure at current step


class OneLegState(NamedTuple):
    u: Any
    temp: Any
    t: Any
    n: Any
    u_prev: Any
    p: Any
    p_prev: Any


def _box_mask(setup):
    g = setup.grid
    m = np.zeros((g.dim, *g.N), np.bool_)
    for a in range(g.dim):
        m[(a,) + slc(g.Iu[a])] = True
    return jnp.asarray(m)


def _dot_boxes(a, b, mask):
    return jnp.sum(jnp.where(mask, a * b, 0.0))


def _solve_implicit_diffusion(rhs, vstart, dt, theta, t, setup, *, maxiter=100):
    """CG solve of (I/dt - (1-theta) D) v = rhs on the velocity DOFs,
    with inhomogeneous BCs carried by `vstart` and homogeneous BC fills
    inside the Krylov loop."""
    mask = _box_mask(setup)
    dtype = setup.dtype
    reltol = float(np.sqrt(np.finfo(dtype).eps))

    def A_hom(w):
        wb = apply_bc_u(w, t, setup, homogeneous=True)
        return wb / dt - (1 - theta) * diffusion(wb, setup)

    def A_full(w):
        return w / dt - (1 - theta) * diffusion(w, setup)

    r = jnp.where(mask, rhs - A_full(vstart), 0.0)
    res0 = jnp.sqrt(_dot_boxes(r, r, mask))
    tol = reltol * res0

    def cond(s):
        _, r, _, res, it = s
        return jnp.logical_and(it < maxiter, res > tol)

    def body(s):
        x, r, p_, res, it = s
        Ap = jnp.where(mask, A_hom(p_), 0.0)
        rr = _dot_boxes(r, r, mask)
        alpha = rr / _dot_boxes(p_, Ap, mask)
        x = x + alpha * p_
        r = r - alpha * Ap
        rr_new = _dot_boxes(r, r, mask)
        beta = rr_new / rr
        p_ = r + beta * p_
        return (x, r, p_, jnp.sqrt(rr_new), it + 1)

    x0 = jnp.where(mask, vstart, 0.0)
    state = (x0, r, r, res0, 0)
    x, *_ = jax.lax.while_loop(cond, body, state)
    # Combine interior solution with boundary values
    return jnp.where(mask, x, vstart)


def create_stepper_abcn(method, *, setup, psolver, u, temp, t):
    assert temp is None, "AB-CN stepper does not support the temperature equation"
    t = jnp.asarray(t, setup.dtype)
    ub = apply_bc_u(u, t, setup)
    c_prev = convection(ub, setup)
    p = pressure(ub, None, t, setup, psolver=psolver)
    return ABCNState(
        u=ub, temp=None, t=t, n=jnp.asarray(0, jnp.int32), c_prev=c_prev, p=p
    )


def _resolve_startup(method):
    ms = method.method_startup
    if ms is None:
        from .rk_methods import RK44

        return RK44()
    return ms or None  # False disables the startup step


def _startup_step(method_startup, u0, t0, dt, setup, psolver, theta):
    """One step of the startup method from (u0, t0); returns u1."""
    from .step import StepperState, timestep

    s = StepperState(
        u=u0, temp=None, t=t0, n=jnp.asarray(0, jnp.int32)
    )
    return timestep(
        method_startup, s, dt, setup=setup, psolver=psolver, theta=theta
    ).u


def timestep_abcn(method, state, dt, *, setup, psolver, theta=None):
    """One IMEX AB-CN step (methods.jl:6-73); the n==0 step runs the
    startup method (reference step_ab_cn.jl:27-60)."""
    startup = _resolve_startup(method)
    if startup is not None:

        def _first(state):
            u0, _, t0, n, c_prev, p0 = state
            u1 = _startup_step(startup, u0, t0, dt, setup, psolver, theta)
            t1 = t0 + dt
            # history for the first real AB step: convection at (u0, t0)
            c0 = convection(apply_bc_u(u0, t0, setup), setup)
            p1 = pressure(u1, None, t1, setup, psolver=psolver)
            return ABCNState(
                u=u1, temp=None, t=t1, n=n + 1, c_prev=c0, p=p1
            )

        def _rest(state):
            return _timestep_abcn_inner(
                method, state, dt, setup=setup, psolver=psolver, theta=theta
            )

        return jax.lax.cond(state.n == 0, _first, _rest, state)
    return _timestep_abcn_inner(
        method, state, dt, setup=setup, psolver=psolver, theta=theta
    )


def _timestep_abcn_inner(method, state, dt, *, setup, psolver, theta=None):
    a1, a2, th = method.alpha1, method.alpha2, method.theta
    u0, _, t0, n, c_prev, p0 = state
    t1 = t0 + dt

    ub = apply_bc_u(u0, t0, setup)
    c0 = convection(ub, setup)
    d0 = diffusion(ub, setup)
    rhs = ub / dt + th * d0 - (a1 * c0 + a2 * c_prev)
    if setup.bodyforce is not None or setup.bodyforce_field is not None:
        f0 = applybodyforce(ub, t0, setup)
        f1 = applybodyforce(ub, t1, setup)
        rhs = rhs + th * f0 + (1 - th) * f1
    p0b = apply_bc_p(p0, t0, setup)
    rhs = rhs - pressuregradient(p0b, setup)
    if setup.closure_model is not None:
        rhs = rhs + setup.closure_model(ub, theta)

    vstart = apply_bc_u(u0, t1, setup)
    v = _solve_implicit_diffusion(rhs, vstart, dt, th, t1, setup)

    # Pressure correction: L dp = W M v / dt
    v = apply_bc_u(v, t1, setup)
    div = scalewithvolume(divergence(v, setup), setup) / dt
    dp = apply_bc_p(poisson(psolver, div), t1, setup)
    u1 = v - dt * pressuregradient(dp, setup)
    u1 = apply_bc_u(u1, t1, setup)

    if method.p_add_solve:
        p1 = pressure(u1, None, t1, setup, psolver=psolver)
    else:
        p1 = p0 + dp
    return ABCNState(u=u1, temp=None, t=t1, n=n + 1, c_prev=c0, p=p1)


def create_stepper_oneleg(method, *, setup, psolver, u, temp, t):
    assert temp is None, "One-leg stepper does not support the temperature equation"
    t = jnp.asarray(t, setup.dtype)
    ub = apply_bc_u(u, t, setup)
    p = pressure(ub, None, t, setup, psolver=psolver)
    # Distinct buffers: the jitted scan donates the state, and the same
    # buffer may not be donated twice
    return OneLegState(
        u=ub, temp=None, t=t, n=jnp.asarray(0, jnp.int32),
        u_prev=jnp.copy(ub), p=p, p_prev=jnp.copy(p),
    )


def timestep_oneleg(method, state, dt, *, setup, psolver, theta=None):
    """One explicit one-leg beta step (Verstappen; methods.jl:90-125); the
    n==0 step runs the startup method (reference step_one_leg.jl:18-30)."""
    startup = _resolve_startup(method)
    if startup is not None:

        def _first(state):
            u0, _, t0, n, u_prev, p0, p_prev = state
            u1 = _startup_step(startup, u0, t0, dt, setup, psolver, theta)
            t1 = t0 + dt
            p1 = pressure(u1, None, t1, setup, psolver=psolver)
            return OneLegState(
                u=u1, temp=None, t=t1, n=n + 1,
                u_prev=u0, p=p1, p_prev=p0,
            )

        def _rest(state):
            return _timestep_oneleg_inner(
                method, state, dt, setup=setup, psolver=psolver, theta=theta
            )

        return jax.lax.cond(state.n == 0, _first, _rest, state)
    return _timestep_oneleg_inner(
        method, state, dt, setup=setup, psolver=psolver, theta=theta
    )


def _timestep_oneleg_inner(method, state, dt, *, setup, psolver, theta=None):
    beta = method.beta
    u0, _, t0, n, u_prev, p0, p_prev = state
    t1 = t0 + dt
    t_off = t0 + beta * dt

    v = (1 + beta) * u0 - beta * u_prev
    Q = (1 + beta) * p0 - beta * p_prev
    v = apply_bc_u(v, t_off, setup)
    F = momentum(v, None, t_off, setup)
    if setup.closure_model is not None:
        F = F + setup.closure_model(v, theta)
    GQ = pressuregradient(apply_bc_p(Q, t_off, setup), setup)
    vt = (
        2 * beta * u0
        - (beta - 0.5) * u_prev
        + dt * F
        - dt * GQ
    ) / (beta + 0.5)

    vt = apply_bc_u(vt, t1, setup)
    div = scalewithvolume(divergence(vt, setup), setup) * (beta + 0.5) / dt
    dp = apply_bc_p(poisson(psolver, div), t1, setup)
    u1 = vt - dt / (beta + 0.5) * pressuregradient(dp, setup)
    u1 = apply_bc_u(u1, t1, setup)

    if method.p_add_solve:
        p1 = pressure(u1, None, t1, setup, psolver=psolver)
    else:
        p1 = 2 * p0 - p_prev + 4 / 3 * dp
    return OneLegState(
        u=u1, temp=None, t=t1, n=n + 1, u_prev=u0, p=p1, p_prev=p0
    )
