"""Implicit Runge-Kutta stepper: Picard or matrix-free Newton-Krylov.

The reference ships a Newton-based DAE stage solver written against its
removed v1 API (src/time_steppers/step_implicit_runge_kutta.jl:1-462,
not callable; `newton_type` in {:full, :approximate}, assembled Jacobian
+ LU). This is an on-device redesign of the same capability: the stage
system

    G(U) = U - u_0 - dt (A (x) I) f(U) = 0,   f = P o F o BC

is solved either by

- **Picard** fixed-point iteration (`newton_type="picard"`): matrix-free,
  cheap per sweep, but converges only in the contraction regime
  `dt * ||df/du|| < 1` — roughly the explicit stability limit; or
- **Newton-Krylov** (`newton_type` "full" / "approximate", the default):
  each Newton step solves `J dU = -G` with J applied matrix-free as

      J V = V - dt (A (x) I) P jvp(F o BC)(U; V)

  via GMRES. The Leray projection P is *linear*, so the exact Jacobian
  action needs only a JVP of the momentum+BC path (which has no
  custom_vjp inside — the Poisson custom_vjp never sees forward-mode).
  "approximate" freezes the linearization point at u_0 (reference's
  cheaper variant); "full" re-linearizes at the current stage iterate.
  This makes Gauss/Radau/SDIRK tableaus genuinely stiff-capable: stable
  far beyond the explicit diffusive limit (tests/test_imex.py).

Both solvers run under a `lax.while_loop` with residual-based
convergence control: stop at `||G|| <= abstol + reltol * ||G_0||`, at
`maxiter`, or when the residual goes non-finite (divergence guard).
The final state gets a projection and BC fill like the explicit steppers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..boundary_conditions import apply_bc_u
from ..ops.operators import momentum
from ..ops.pressure import project
from .step import StepperState

__all__ = ["timestep_irk"]


def _gmres(matvec, b, *, m=12, cycles=1):
    """Matrix-free GMRES(m), hand-rolled on `fori_loop` Arnoldi.

    jax.scipy.sparse.linalg.gmres wraps the operator in
    `lax.custom_linear_solve`, which *transposes* the matvec — impossible
    here (the Leray projection inside carries the Poisson `custom_vjp`).
    This version has no AD machinery: fixed m Arnoldi steps per cycle,
    small dense least-squares, works on any pytree-free array `b`.
    Unfilled Krylov rows are zero, so the Gram-Schmidt loop needs no
    masking (dot products with zero rows are no-ops)."""
    shape = b.shape
    dtype = b.dtype
    bf = b.reshape(-1)
    N = bf.shape[0]
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny * 1e6, dtype)

    def mv(x):
        return matvec(x.reshape(shape)).reshape(-1)

    def cycle(x, _):
        r = bf - mv(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, N), dtype).at[0].set(r / (beta + tiny))
        H = jnp.zeros((m + 1, m), dtype)

        def arnoldi(j, carry):
            V, H = carry
            w = mv(V[j])

            def gs(i, wh):
                w, hcol = wh
                hij = jnp.dot(V[i], w)
                return (w - hij * V[i], hcol.at[i].set(hij))

            w, hcol = jax.lax.fori_loop(
                0, m + 1, gs, (w, jnp.zeros(m + 1, dtype))
            )
            hj1 = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hj1)
            V = V.at[j + 1].set(w / (hj1 + tiny))
            return (V, H.at[:, j].set(hcol))

        V, H = jax.lax.fori_loop(0, m, arnoldi, (V, H))
        e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        return x + jnp.tensordot(y, V[:m], axes=1), None

    x, _ = jax.lax.scan(cycle, jnp.zeros_like(bf), None, length=cycles)
    return x.reshape(shape)


def timestep_irk(method, state, dt, *, setup, psolver, theta=None, niter=None):
    """One implicit-RK step (Gauss/Radau/Lobatto/DIRK tableaus from
    `RKMethods`). Solver selection via `method.newton_type`."""
    u0, temp, t0, n = state
    assert temp is None, "Implicit RK does not support the temperature equation"
    dtype = setup.dtype
    A = jnp.asarray(method.A, dtype)
    b = jnp.asarray(method.b, dtype)
    c = jnp.asarray(method.c, dtype)
    s = len(method.b)
    maxiter = niter if niter is not None else method.maxiter
    eps = float(np.finfo(dtype).eps)
    reltol = max(float(method.reltol), 50 * eps)
    abstol = max(float(method.abstol), 0.0)
    newton_type = getattr(method, "newton_type", "full")

    def F_bc(u, ti):
        ub = apply_bc_u(u, ti, setup)
        F = momentum(ub, None, ti, setup)
        if setup.closure_model is not None:
            F = F + setup.closure_model(ub, theta)
        return apply_bc_u(F, ti, setup, dudt=True)

    def f(u, ti):
        return project(F_bc(u, ti), setup, psolver=psolver)

    ts = t0 + c * dt

    def stage_rhs(U):
        return jnp.stack([f(U[i], ts[i]) for i in range(s)])

    def residual(U):
        return U - u0[None] - dt * jnp.tensordot(A, stage_rhs(U), axes=([1], [0]))

    def resnorm(G):
        return jnp.sqrt(jnp.sum(G * G))

    U0 = jnp.broadcast_to(u0, (s, *u0.shape)) + jnp.zeros((s, *u0.shape), dtype)
    G0 = residual(U0)
    tol = abstol + reltol * resnorm(G0)

    def cond(carry):
        U, G, res, it = carry
        return jnp.logical_and(
            jnp.logical_and(it < maxiter, res > tol), jnp.isfinite(res)
        )

    if newton_type == "picard":

        def body(carry):
            U, G, _, it = carry
            U = U - G  # U <- u0 + dt A K(U)  (G = U - that)
            Gn = residual(U)
            return (U, Gn, resnorm(Gn), it + 1)

    else:

        def make_matvec(Ulin):
            def matvec(V):
                dK = []
                for i in range(s):
                    _, dF = jax.jvp(
                        lambda u: F_bc(u, ts[i]), (Ulin[i],), (V[i],)
                    )
                    dK.append(project(dF, setup, psolver=psolver))
                dK = jnp.stack(dK)
                return V - dt * jnp.tensordot(A, dK, axes=([1], [0]))

            return matvec

        def body(carry):
            U, G, res, it = carry
            Ulin = U0 if newton_type == "approximate" else U
            dU = _gmres(make_matvec(Ulin), -G, m=12, cycles=1)
            U = U + dU
            Gn = residual(U)
            return (U, Gn, resnorm(Gn), it + 1)

    U, G, _, _ = jax.lax.while_loop(
        cond, body, (U0, G0, resnorm(G0), jnp.asarray(0, jnp.int32))
    )
    u1 = u0 + dt * jnp.tensordot(b, stage_rhs(U), axes=([0], [0]))

    t1 = t0 + dt
    u1 = apply_bc_u(u1, t1, setup)
    u1 = project(u1, setup, psolver=psolver)
    u1 = apply_bc_u(u1, t1, setup)
    return StepperState(u=u1, temp=None, t=t1, n=n + 1)
