"""Fast-diagonalization (tensor-product) direct Poisson solver.

The pressure Laplacian on ANY tensor-product grid (uniform or stretched,
any BC mix) is separable: L = Omega * sum_d K_d with K_d acting along
dimension d only. Each 1-D operator satisfies the generalized symmetric
eigenproblem M_d v = lambda diag(Delta_d) v (M_d = diag(Delta_d) K_d is
the symmetric volume-scaled 1-D Laplacian), so

    p = (x V_d) [ (x V_d^-1) (f / Omega) / (sum_d lambda_d) ]

— D tensor contractions in, a diagonal solve, D contractions out: an
*exact* direct solve in O(N^(D+1)) flops as dense on-device matmuls,
fully jittable and differentiable, replacing hundreds of CG iterations
on stretched/Dirichlet grids and the host-side sparse factorization
(reference psolver_direct, src/pressure.jl:117-154).

Eigendecompositions are precomputed once per setup in float64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

from ..boundary_conditions import SymmetricBC
from ._stencil import slc

__all__ = ["psolver_fdm", "fdm_solve_box", "fdm_transform_roundoff"]


def fdm_transform_roundoff(setup):
    """Host-side estimate of the relative roundoff the working dtype's
    eigen transforms leave in a `fdm_solve_box` round trip: per axis,
    ``max ||V (V^T diag(delta) x) - x|| / ||x||`` over a random probe,
    computed in the working precision.  Cheap (1-D dense matmuls at
    setup time); used to decide whether iterative refinement is needed
    for a given grid/precision (e.g. the channel fast path)."""
    g = setup.grid
    wdt = np.float32 if setup.dtype == jnp.float32 else np.float64
    rng = np.random.RandomState(0)
    err = 0.0
    for d in range(g.dim):
        delta = np.asarray(g.delta[d], np.float64)[g.Ip[d][0] : g.Ip[d][1]]
        M = _one_dim_operator(setup, d)
        lam, V = scipy.linalg.eigh(M, np.diag(delta))
        V32 = V.astype(wdt)
        Vinv32 = (V.T * delta[None, :]).astype(wdt)
        x = rng.randn(len(delta), 8).astype(wdt)
        y = V32 @ (Vinv32 @ x)
        err = max(
            err,
            float(
                np.linalg.norm(y - x, axis=0).max()
                / np.linalg.norm(x, axis=0).min()
            ),
        )
    return err


def _one_dim_operator(setup, d):
    """Dense 1-D operator M_d (Np_d x Np_d): row i of
    cl[i] p[i-1] + cc[i] p[i] + cr[i] p[i+1], with the ghost closure of
    the BC folded in (periodic wrap; SymmetricBC ghost = interior copy
    folds into the diagonal; Dirichlet/Pressure rows already have zero
    ghost coefficients in lap_c)."""
    g = setup.grid
    cl, cc, cr = (np.asarray(a, np.float64) for a in g.lap_c[d])
    npd = g.Np[d]
    bcl, bcr = setup.boundary_conditions[d]
    M = np.zeros((npd, npd))
    for i in range(npd):
        M[i, i] = cc[i]
        if i - 1 >= 0:
            M[i, i - 1] = cl[i]
        elif g.periodic[d]:
            M[i, npd - 1] = cl[i]
        elif isinstance(bcl, SymmetricBC):
            M[i, i] += cl[i]  # ghost p[-1] = p[0]
        if i + 1 < npd:
            M[i, i + 1] = cr[i]
        elif g.periodic[d]:
            M[i, 0] = cr[i]
        elif isinstance(bcr, SymmetricBC):
            M[i, i] += cr[i]  # ghost p[np] = p[np-1]
    return M


def fdm_solve_box(setup):
    """The core fast-diagonalization solve map on the interior DOF box:
    ``fbox -> pbox`` with ``L p = f`` solved exactly (up to working
    precision) by per-axis eigen contractions.

    As an operator the map is ``(x V_d) inv_denom (x V_d^T)`` — the
    per-axis volume weights in ``V^-1 = V^T diag(delta)`` cancel against
    the up-front ``1/Omega`` scaling — i.e. SYMMETRIC in the plain dot
    product, which makes it a valid (near-exact) CG preconditioner
    (`psolver_cg(precond="fdm")`).

    The contractions run at `Precision.HIGHEST`: a reduced-precision
    product (TF32 on the GPU) leaves ~1e-3 of the divergence on the
    256x128x128 channel, which misses the reference CG solver's
    reltol=1e-4 (src/pressure.jl:209-215).
    """
    g = setup.grid
    D = g.dim
    dtype = setup.dtype

    Vs, Vinvs, lams = [], [], []
    for d in range(D):
        delta = np.asarray(g.delta[d], np.float64)[g.Ip[d][0] : g.Ip[d][1]]
        # K_d = diag(1/delta) T_d with T_d the (symmetric) tridiagonal of
        # lap_c rows; generalized eigenproblem T v = lam diag(delta) v
        M = _one_dim_operator(setup, d)
        assert np.allclose(M, M.T, atol=1e-12), "1-D operator not symmetric"
        lam, V = scipy.linalg.eigh(M, np.diag(delta))
        # V is delta-orthonormal: V^T diag(delta) V = I -> V^-1 = V^T diag(delta)
        Vs.append(jnp.asarray(V, dtype))
        Vinvs.append(jnp.asarray(V.T * delta[None, :], dtype))
        lams.append(lam)

    # Eigenvalue denominator sum_d lam_d (broadcast over the box)
    denom = np.zeros(g.Np)
    for d in range(D):
        denom = denom + lams[d].reshape(
            [-1 if i == d else 1 for i in range(D)]
        )
    # Zero (nullspace) modes: pin to zero like the spectral solver's k=0
    small = np.abs(denom) < 1e-8 * np.max(np.abs(denom))
    denom_safe = np.where(small, 1.0, denom)
    inv_denom = jnp.asarray(
        np.where(small, 0.0, 1.0 / denom_safe), dtype
    )

    # Volume weights over the DOF box
    om = np.ones(g.Np)
    for d in range(D):
        delta = np.asarray(g.delta[d], np.float64)[g.Ip[d][0] : g.Ip[d][1]]
        om = om * delta.reshape([-1 if i == d else 1 for i in range(D)])
    inv_om = jnp.asarray(1.0 / om, dtype)

    prec = jax.lax.Precision.HIGHEST

    def _contract(x, mats):
        # Apply mats[d] along dimension d: x <- mats[d] @_d x.
        for d in range(D):
            x = jnp.tensordot(mats[d], x, axes=([1], [d]), precision=prec)
            x = jnp.moveaxis(x, 0, d)
        return x

    def _solve_box(fbox):
        fhat = _contract(fbox * inv_om, Vinvs)
        return _contract(fhat * inv_denom, Vs)

    return _solve_box


def psolver_fdm(setup, *, nrefine=None):
    """Direct Poisson solver by fast diagonalization (see module docs).

    `nrefine`: iterative-refinement steps `p += L~^-1 (f - L p)` to squash
    working-precision transform error (defaults to 1 in float32 — rel
    error ~1e-5 -> ~1e-9 on strongly stretched grids — and 0 in float64).
    """
    g = setup.grid
    dtype = setup.dtype
    ip = slc(g.Ip)
    if nrefine is None:
        nrefine = 1 if dtype == jnp.float32 else 0
    _solve_box = fdm_solve_box(setup)

    def psolve(p):
        from ..boundary_conditions import apply_bc_p
        from .operators import laplacian

        f = p[ip]
        sol = _solve_box(f)
        for _ in range(nrefine):
            pb = apply_bc_p(
                jnp.zeros(g.N, p.dtype).at[ip].set(sol),
                jnp.asarray(0.0, p.dtype),
                setup,
            )
            r = f - laplacian(pb, setup)[ip]
            sol = sol + _solve_box(r)
        return p.at[ip].set(sol.astype(p.dtype))

    psolve.is_fdm = True
    psolve.is_direct = True
    return psolve
