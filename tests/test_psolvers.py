"""Pressure solver tests (mirrors reference test/psolvers.jl): spectral,
CG, and direct solvers reproduce an analytic pressure from its Laplacian."""

import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins
from ins_tpu.ops._stencil import slc
from ins_tpu.ops.pressure import poisson, psolver_cg, psolver_spectral


@pytest.fixture(scope="module")
def periodic_setup():
    n = 32
    x = (np.linspace(0, 2 * np.pi, n + 1), np.linspace(0, 2 * np.pi, n + 1))
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 2
    return ins.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=jnp.float64)


def _analytic_case(setup):
    """p = sin(x) cos(y): compute f = Omega * Lap p and check recovery."""
    g = setup.grid
    xp, yp = np.meshgrid(
        np.asarray(g.xp[0]), np.asarray(g.xp[1]), indexing="ij"
    )
    p_exact = jnp.asarray(np.sin(xp) * np.cos(yp))
    p_exact = ins.apply_bc_p(p_exact, jnp.asarray(0.0, setup.dtype), setup)
    f = ins.laplacian(p_exact, setup)
    return p_exact, f


def _check(psolve, setup, tol):
    p_exact, f = _analytic_case(setup)
    p = poisson(psolve, f)
    ip = slc(setup.grid.Ip)
    pe = np.asarray(p_exact[ip])
    pn = np.asarray(p[ip])
    # Pressure defined up to a constant
    pn = pn - pn.mean() + pe.mean()
    assert np.max(np.abs(pn - pe)) < tol


def test_spectral(periodic_setup):
    _check(psolver_spectral(periodic_setup), periodic_setup, 1e-10)


def test_cg(periodic_setup):
    _check(psolver_cg(periodic_setup), periodic_setup, 1e-5)


def test_default_picks_spectral(periodic_setup):
    # uniform periodic -> spectral
    p = ins.default_psolver(periodic_setup)
    _check(p, periodic_setup, 1e-10)


def test_cg_dirichlet(setup2d):
    """CG on a stretched Dirichlet grid: solve L p = L p_ref and compare."""
    import jax

    g = setup2d.grid
    key = jax.random.PRNGKey(11)
    p_ref = jax.random.normal(key, g.N, setup2d.dtype)
    p_ref = ins.apply_bc_p(p_ref, jnp.asarray(0.0, setup2d.dtype), setup2d)
    # Remove nullspace component (constant)
    ip = slc(g.Ip)
    p_ref = p_ref.at[ip].add(-jnp.mean(p_ref[ip]))
    p_ref = ins.apply_bc_p(p_ref, jnp.asarray(0.0, setup2d.dtype), setup2d)
    f = ins.laplacian(p_ref, setup2d)
    psolve = psolver_cg(setup2d, reltol=1e-12)
    p = poisson(psolve, f)
    pe = np.asarray(p_ref[ip])
    pn = np.asarray(p[ip])
    pn = pn - pn.mean() + pe.mean()
    assert np.max(np.abs(pn - pe)) < 1e-6


def test_project_divergence_free(setup2d, u2d):
    """After projection the divergence of u vanishes on the DOFs."""
    setup = setup2d
    psolve = psolver_cg(setup, reltol=1e-12)
    u = ins.project(u2d, setup, psolver=psolve)
    div = ins.divergence(u, setup)
    assert float(jnp.max(jnp.abs(div))) < 1e-8


def test_cg_matrix(periodic_setup):
    """Assembled-matrix CG (reference psolver_cg_matrix,
    src/pressure.jl:161-185) reproduces the analytic pressure."""
    from ins_tpu.ops.pressure import psolver_cg_matrix

    _check(psolver_cg_matrix(periodic_setup), periodic_setup, 1e-5)


def test_cg_matrix_dirichlet(setup2d):
    from ins_tpu.ops.pressure import psolver_cg_matrix

    g = setup2d.grid
    import jax

    p_ref = jax.random.normal(jax.random.PRNGKey(11), g.N, setup2d.dtype)
    p_ref = ins.apply_bc_p(p_ref, jnp.asarray(0.0, setup2d.dtype), setup2d)
    ip = slc(g.Ip)
    p_ref = p_ref.at[ip].add(-jnp.mean(p_ref[ip]))
    p_ref = ins.apply_bc_p(p_ref, jnp.asarray(0.0, setup2d.dtype), setup2d)
    f = ins.laplacian(p_ref, setup2d)
    p = poisson(psolver_cg_matrix(setup2d, reltol=1e-12), f)
    pe = np.asarray(p_ref[ip])
    pn = np.asarray(p[ip])
    pn = pn - pn.mean() + pe.mean()
    assert np.max(np.abs(pn - pe)) < 1e-6


def test_direct_honoured_in_solve_unsteady(periodic_setup):
    """solve_unsteady runs the user's psolver_direct as given (its
    pure_callback works under jit on every backend) and matches the
    spectral solve."""
    import warnings

    from ins_tpu.ops.pressure import psolver_direct

    setup = periodic_setup
    u0 = ins.velocityfield(
        setup,
        lambda d, x, y: jnp.sin(x) * jnp.cos(y) * (1.0 if d == 0 else -1.0),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state, _ = ins.solve_unsteady(
            setup=setup, ustart=u0, tlims=(0.0, 2e-3), dt=1e-3,
            psolver=psolver_direct(setup), method=ins.RKMethods.SSP22(),
        )
    ref, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, 2e-3), dt=1e-3,
        psolver=psolver_cg(setup, reltol=1e-13),
        method=ins.RKMethods.SSP22(),
    )
    assert float(jnp.max(jnp.abs(state.u - ref.u))) < 1e-9


def test_cg_fdm_precond(periodic_setup):
    """FDM-preconditioned CG (VERDICT-r4 item 3a): exact preconditioner
    on a separable grid -> O(1) iterations to the analytic pressure."""
    _check(
        psolver_cg(periodic_setup, precond="fdm", maxiter=4), periodic_setup,
        1e-5,
    )


def test_cg_fdm_precond_cavity():
    """Uniform all-Dirichlet cavity cube: FDM-CG with a tiny maxiter must
    match plain (Jacobi) CG run to tight tolerance."""
    n = 16
    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    d = ins.DirichletBC()
    bc = ((d, d), (d, d), (d, ins.DirichletBC((1.0, 0.0, 0.0))))
    setup = ins.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=jnp.float64)
    g = setup.grid
    import jax

    p_ref = jax.random.normal(jax.random.PRNGKey(5), g.N, setup.dtype)
    p_ref = ins.apply_bc_p(p_ref, jnp.asarray(0.0, setup.dtype), setup)
    ip = slc(g.Ip)
    p_ref = p_ref.at[ip].add(-jnp.mean(p_ref[ip]))
    p_ref = ins.apply_bc_p(p_ref, jnp.asarray(0.0, setup.dtype), setup)
    f = ins.laplacian(p_ref, setup)
    p = poisson(psolver_cg(setup, precond="fdm", maxiter=4, reltol=1e-12), f)
    pe = np.asarray(p_ref[ip])
    pn = np.asarray(p[ip])
    pn = pn - pn.mean() + pe.mean()
    assert np.max(np.abs(pn - pe)) < 1e-9
