"""Pressure-Poisson solvers and projection.

Re-design of IncompressibleNavierStokes.jl `src/pressure.jl`:

- `psolver_spectral`: batched XLA real-FFT solve on uniform periodic grids
  (eigenvalue formula of src/pressure.jl:303-311). The FFT runs on-device
  (cuFFT on the GPU); under a sharded mesh XLA decomposes it with
  all-to-all transposes.
- `psolver_cg`: matrix-free preconditioned conjugate gradients as a
  `lax.while_loop` (port of the iteration of src/pressure.jl:209-286 with
  the diagonal-Laplace preconditioner of :188-206). Fully jittable and
  differentiable through the self-adjoint `poisson` custom_vjp.
- `psolver_direct`: host-side sparse factorization (SuiteSparse equivalent
  via scipy.sparse.linalg) wrapped in `jax.pure_callback` for small
  general-BC grids (reference src/pressure.jl:117-154, CUDSS ext).

`poisson` carries a custom VJP exploiting self-adjointness of the Laplacian
(reference rrule at src/pressure.jl:18-19), so reverse-mode AD never
differentiates through FFT internals or the CG loop.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..boundary_conditions import PeriodicBC, PressureBC, apply_bc_p
from ._stencil import slc
from .operators import (
    applypressure,
    divergence,
    laplacian,
    momentum,
    pressuregradient,
    scalewithvolume,
)

__all__ = [
    "default_psolver",
    "psolver_spectral",
    "spectral_inverse_laplacian",
    "psolver_cg",
    "psolver_cg_matrix",
    "psolver_direct",
    "poisson",
    "pressure",
    "project",
]


def default_psolver(setup):
    """Spectral on uniform periodic grids, fast-diagonalization direct
    solve otherwise (selection logic mirrors src/pressure.jl:85-98:
    spectral iff uniform periodic, else a direct solver — here the
    on-device tensor-product diagonalization of ops/fdm.py instead of a
    host-side sparse factorization). `psolver_cg` and `psolver_direct`
    remain available."""
    g = setup.grid
    if all(g.periodic) and all(g.uniform):
        return psolver_spectral(setup)
    from .fdm import psolver_fdm

    return psolver_fdm(setup)


# --------------------------------------------------------------------------
# Spectral solver (uniform periodic)
# --------------------------------------------------------------------------


def spectral_inverse_laplacian(Np, dxs, dtype=jnp.float64):
    """Real-FFT multiplier of the inverse volume-scaled periodic Laplacian
    (rfft over the last axis):
    ``-1 / sum_d 4 vol sin^2(pi k_d / n_d) / dx_d^2``
    (src/pressure.jl:303-311) with the k=0 (zero-mean) mode pinned to 0.
    Built by broadcasting per-axis 1-D eigenvalue vectors, so inside a
    jitted function the N-D multiplier is computed in-graph (and fused
    into the multiply) rather than embedded as an n^D constant."""
    D = len(Np)
    vol = float(np.prod(dxs))
    den = 0.0
    for d in range(D):
        k = np.arange(Np[d] // 2 + 1 if d == D - 1 else Np[d])
        lam = 4 * vol * np.sin(np.pi * k / Np[d]) ** 2 / dxs[d] ** 2
        den = den + jnp.asarray(
            lam.reshape([-1 if i == d else 1 for i in range(D)]), dtype
        )
    # every per-axis eigenvalue is >= 0 and vanishes only at k_d = 0, so
    # den == 0 exactly at the zero-mean mode
    return jnp.where(den == 0, 0.0, -1.0 / jnp.where(den == 0, 1.0, den))


def psolver_spectral(setup):
    """FFT Poisson solver on a uniform periodic grid: one real-FFT pair
    (cuFFT on the GPU) and the eigenvalue multiplier of
    `spectral_inverse_laplacian`.  The real transform runs over the
    *last* axis rather than the reference's first.
    """
    g = setup.grid
    D = g.dim
    if not (all(g.periodic) and all(g.uniform)):
        raise ValueError("Spectral psolver requires a uniform periodic grid")
    dx = [float(np.asarray(g.delta[d])[0]) for d in range(D)]
    Np = tuple(g.Np)
    ip = slc(setup.grid.Ip)

    def psolve(p):
        f = p[ip]
        inv_denom = spectral_inverse_laplacian(Np, dx, setup.dtype)
        phat = jnp.fft.rfftn(f) * inv_denom
        sol = jnp.fft.irfftn(phat, f.shape).astype(p.dtype)
        return p.at[ip].set(sol)

    psolve.is_spectral = True  # enables the ghost-free periodic fast path
    return psolve


# --------------------------------------------------------------------------
# Matrix-free preconditioned CG
# --------------------------------------------------------------------------


def psolver_cg(setup, *, abstol=0.0, reltol=None, maxiter=None,
               precond="jacobi"):
    """Matrix-free preconditioned CG as a `lax.while_loop`
    (src/pressure.jl:209-286).

    ``precond``: "jacobi" (reference's diagonal-Laplace preconditioner,
    src/pressure.jl:188-206) or "fdm" — the fast-diagonalization eigen
    solve (`ops/fdm.py`) as M^-1.  The FDM map is the EXACT inverse on
    any separable grid (it is symmetric in the plain dot product, see
    `fdm_solve_box`), so FDM-CG converges in O(1) iterations there and
    stays a cheap near-exact preconditioner otherwise; each application
    is D dense tensor contractions instead of hundreds of stencil sweeps.
    """
    g = setup.grid
    dtype = setup.dtype
    if reltol is None:
        reltol = math.sqrt(float(np.finfo(dtype).eps))
    if maxiter is None:
        maxiter = int(np.prod(g.Np))
    ip = slc(g.Ip)

    # Diagonal-Laplace preconditioner (src/pressure.jl:188-206): uses the
    # *unmodified* center coefficient in every row.
    om_over = []
    box = g.Ip
    from ._stencil import seg

    om = 1.0
    for d in range(g.dim):
        om = om * seg(g.delta[d], box, d)
    diag = 0.0
    for d in range(g.dim):
        shape = [1] * g.dim
        shape[d] = box[d][1] - box[d][0]
        diag = diag + om / seg(g.delta[d], box, d) * jnp.reshape(
            g.plap_diag[d], shape
        )

    if precond == "fdm":
        from .fdm import fdm_solve_box

        _solve_box = fdm_solve_box(setup)

        def apply_precond(r):
            z = jnp.zeros(g.N, dtype)
            return z.at[ip].set(_solve_box(r[ip]))

    elif precond == "jacobi":

        def apply_precond(r):
            # z = -r / d with d the (negative) unmodified diagonal
            # (src/pressure.jl:191-201)
            z = jnp.zeros(g.N, dtype)
            return z.at[ip].set(-r[ip] / diag)

    else:
        raise ValueError(f"unknown precond {precond!r}")

    def inner(a, b):
        return jnp.sum(a[ip] * b[ip])

    zerot = jnp.asarray(0.0, dtype)

    # Without a PressureBC the Laplacian is singular (nullspace of
    # constants): project the RHS onto range(L) = zero-sum fields, the CG
    # analogue of the reference's nullspace augmentation [L e; e' 0]
    # (src/pressure.jl:133-141). Keeps the solve map self-adjoint even for
    # inconsistent inputs (e.g. AD cotangents).
    issingular = not any(
        isinstance(bc, PressureBC)
        for bcs in setup.boundary_conditions
        for bc in bcs
    )
    npoints = float(np.prod(g.Np))

    def psolve(f):
        if issingular:
            mean = jnp.sum(f[ip]) / npoints
            f = f.at[ip].add(-mean)
        r = f  # initial residual (q=0)
        residual0 = jnp.sqrt(inner(r, r))
        tolerance = jnp.maximum(reltol * residual0, abstol)
        p = jnp.zeros_like(f)
        q = jnp.zeros_like(f)
        state = (p, r, q, jnp.asarray(1.0, dtype), residual0, 0)

        def cond(state):
            _, _, _, _, residual, it = state
            return jnp.logical_and(it < maxiter, residual > tolerance)

        def body(state):
            p, r, q, rho_prev, residual, it = state
            z = apply_precond(r)
            rho = inner(z, r)
            beta = rho / rho_prev
            q = z + beta * q
            qb = apply_bc_p(q, zerot, setup)
            Lq = laplacian(qb, setup)
            alpha = rho / inner(qb, Lq)
            p = p + alpha * qb
            r = r - alpha * Lq
            residual = jnp.sqrt(inner(r, r))
            return (p, r, qb, rho, residual, it + 1)

        p, *_ = jax.lax.while_loop(cond, body, state)
        if issingular:
            # Pin the nullspace gauge (zero-mean pressure): makes the
            # solve map symmetric, P0 L+ P0, so the self-adjoint poisson
            # VJP is exact
            p = p.at[ip].add(-jnp.sum(p[ip]) / npoints)
        return p

    psolve.is_cg = True
    return psolve


def psolver_cg_matrix(setup, *, abstol=0.0, reltol=None, maxiter=None):
    """CG on the *assembled* sparse pressure Laplacian
    (reference psolver_cg_matrix, src/pressure.jl:161-185).

    The matrix lives on device as a BCOO and the matvec runs inside the
    jitted `lax.while_loop` — useful when the operator has been
    inspected/modified as an explicit matrix. For production use prefer
    `psolver_cg` (matrix-free stencil) or `psolver_fdm`
    (direct). The singular (no PressureBC) case is handled by zero-mean
    projection — the CG-space analogue of the reference's bordered
    system [L e; e' 0]."""
    import jax.experimental.sparse as jsparse

    from .matrices import laplacian_mat

    g = setup.grid
    dtype = setup.dtype
    if reltol is None:
        reltol = math.sqrt(float(np.finfo(dtype).eps))
    if maxiter is None:
        maxiter = int(np.prod(g.Np))
    ip = slc(g.Ip)
    nflat = int(np.prod(g.N))

    Lsp = laplacian_mat(setup).tocoo()
    L = jsparse.BCOO(
        (jnp.asarray(Lsp.data, dtype),
         jnp.asarray(np.stack([Lsp.row, Lsp.col], 1))),
        shape=Lsp.shape,
    )
    # restriction pressure-DOF flat <- full-grid flat
    idx = np.arange(nflat).reshape(g.N)[ip].ravel()
    idxj = jnp.asarray(idx)
    diag = np.asarray(Lsp.tocsr().diagonal())
    diag = np.where(np.abs(diag) > 0, diag, 1.0)
    invdiag = jnp.asarray(1.0 / diag, dtype)

    issingular = not any(
        isinstance(bc, PressureBC)
        for bcs in setup.boundary_conditions
        for bc in bcs
    )
    npoints = float(np.prod(g.Np))

    def psolve(p):
        f = p.reshape(-1)[idxj]
        if issingular:
            f = f - jnp.sum(f) / npoints
        r = f
        residual0 = jnp.sqrt(jnp.sum(r * r))
        tolerance = jnp.maximum(reltol * residual0, abstol)
        x = jnp.zeros_like(f)
        q = jnp.zeros_like(f)
        state = (x, r, q, jnp.asarray(1.0, dtype), residual0, 0)

        def cond(s):
            *_, residual, it = s
            return jnp.logical_and(it < maxiter, residual > tolerance)

        def body(s):
            x, r, q, rho_prev, residual, it = s
            z = r * invdiag
            rho = jnp.sum(z * r)
            beta = rho / rho_prev
            q = z + beta * q
            Lq = L @ q
            alpha = rho / jnp.sum(q * Lq)
            x = x + alpha * q
            r = r - alpha * Lq
            return (x, r, q, rho, jnp.sqrt(jnp.sum(r * r)), it + 1)

        x, *_ = jax.lax.while_loop(cond, body, state)
        if issingular:
            x = x - jnp.sum(x) / npoints
        return p.at[ip].set(x.reshape(g.Np).astype(p.dtype))

    psolve.is_cg = True
    return psolve


# --------------------------------------------------------------------------
# Host-side sparse direct solver
# --------------------------------------------------------------------------


def psolver_direct(setup):
    """Direct Poisson solver via host-side sparse LU (scipy), with rank-1
    nullspace augmentation `[L e; e' 0]` when the operator is singular
    (no PressureBC anywhere), cf. src/pressure.jl:117-154. Wrapped in
    `jax.pure_callback` so it composes with jit; every solve round-trips
    the RHS through the host, so hot loops are faster on CG, FDM or
    spectral solves."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from .matrices import laplacian_mat

    g = setup.grid
    dtype = setup.dtype
    L = laplacian_mat(setup)
    n = int(np.prod(g.Np))
    isdefinite = any(
        isinstance(bc, PressureBC)
        for bcs in setup.boundary_conditions
        for bc in bcs
    )
    if isdefinite:
        solve = spla.factorized(sp.csc_matrix(L.astype(np.float64)))

        def host_solve(fvec):
            fvec = np.asarray(fvec)
            return solve(fvec.astype(np.float64)).astype(fvec.dtype)

    else:
        e = np.ones((n, 1))
        Laug = sp.bmat([[L, e], [e.T, None]], format="csc").astype(np.float64)
        solve = spla.factorized(Laug)

        def host_solve(fvec):
            fvec = np.asarray(fvec)
            rhs = np.concatenate([fvec.astype(np.float64), [0.0]])
            return solve(rhs)[:n].astype(fvec.dtype)

    ip = slc(g.Ip)

    def psolve(p):
        f = p[ip].reshape(-1)
        if isinstance(f, jax.core.Tracer):
            # Under jit: host callback
            sol = jax.pure_callback(
                host_solve, jax.ShapeDtypeStruct(f.shape, f.dtype), f,
                vmap_method="sequential",
            )
        else:
            sol = jnp.asarray(host_solve(np.asarray(f)))
        return p.at[ip].set(sol.reshape(g.Np))

    return psolve


# --------------------------------------------------------------------------
# poisson / pressure / project
# --------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def poisson(psolver, f):
    """Solve the pressure-Poisson equation. Self-adjoint custom VJP
    (reference rrule, src/pressure.jl:18-19)."""
    return psolver(f)


def _poisson_fwd(psolver, f):
    return psolver(f), None


def _poisson_bwd(psolver, _, phibar):
    return (psolver(phibar),)


poisson.defvjp(_poisson_fwd, _poisson_bwd)


def pressure(u, temp, t, setup, *, psolver):
    """Recover pressure consistent with a velocity field
    (src/pressure.jl:30-38)."""
    from ..boundary_conditions import apply_bc_u

    F = momentum(u, temp, t, setup)
    F = apply_bc_u(F, t, setup, dudt=True)
    div = divergence(F, setup)
    div = scalewithvolume(div, setup)
    p = poisson(psolver, div)
    return apply_bc_p(p, t, setup)


def project(u, setup, *, psolver):
    """Project velocity onto its divergence-free part
    (src/pressure.jl:52-66)."""
    div = divergence(u, setup)
    div = scalewithvolume(div, setup)
    p = poisson(psolver, div)
    p = apply_bc_p(p, jnp.asarray(0.0, setup.dtype), setup)
    return applypressure(u, p, setup)
