"""Explicit shard_map halo-exchange stepping vs single-device references
(must match to roundoff): 1-D slab and 2-D pencil meshes, pencil-FFT and
psum-CG pressure solves, Boussinesq temperature coupling, steady body
force, Smagorinsky closure, LMWray3, donation semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins
from ins_tpu.ops.fastpath import make_fast_timestep, strip_ghosts
from ins_tpu.parallel import make_mesh
from ins_tpu.parallel.halo import (
    make_halo_fast_step,
    shard_interior,
    shard_scalar,
)
from ins_tpu.time_steppers.step import StepperState

needs8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _setup3d(n=16, temperature=None):
    x = (np.linspace(0, 2 * np.pi, n + 1),) * 3
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    return ins.Setup(
        x=x, boundary_conditions=bc, Re=1e3, temperature=temperature,
        dtype=jnp.float64,
    )


def _ref_fast(setup, u0, dt, nsteps):
    method = ins.RKMethods.RK44()
    fast = make_fast_timestep(setup, method)
    s = StepperState(u=u0, temp=None, t=jnp.asarray(0.0), n=jnp.asarray(0))
    for _ in range(nsteps):
        s = fast(s, jnp.asarray(dt), None)
    return s


@needs8
@pytest.mark.parametrize("nshards", [2, 4, 8])
def test_halo_step_matches_fastpath(nshards):
    n = 16
    setup = _setup3d(n)
    ps = ins.psolver_spectral(setup)
    method = ins.RKMethods.RK44()
    ug = ins.random_field(setup, kp=3, psolver=ps, rng=jax.random.PRNGKey(0))
    u0 = strip_ghosts(ug)
    dt = 5e-3
    s_ref = _ref_fast(setup, u0, dt, 5)

    mesh = make_mesh((nshards,), devices=jax.devices()[:nshards])
    step = make_halo_fast_step(setup, method, mesh)
    s_par = StepperState(
        u=shard_interior(mesh, u0), temp=None,
        t=jnp.asarray(0.0), n=jnp.asarray(0),
    )
    for _ in range(5):
        s_par = step(s_par, dt)

    diff = float(jnp.max(jnp.abs(s_par.u - s_ref.u)))
    assert diff < 1e-12, diff


@needs8
@pytest.mark.parametrize("mshape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("psolver", ["pencil", "cg"])
def test_halo_2d_mesh(mshape, psolver):
    """x/y-pencil decomposition, both pressure solves == single device."""
    n = 16
    setup = _setup3d(n)
    ps = ins.psolver_spectral(setup)
    method = ins.RKMethods.RK44()
    ug = ins.random_field(setup, kp=3, psolver=ps, rng=jax.random.PRNGKey(1))
    u0 = strip_ghosts(ug)
    dt = 5e-3
    s_ref = _ref_fast(setup, u0, dt, 3)

    ndev = int(np.prod(mshape))
    mesh = make_mesh(mshape, devices=jax.devices()[:ndev])
    step = make_halo_fast_step(setup, method, mesh, psolver=psolver)
    s_par = StepperState(
        u=shard_interior(mesh, u0), temp=None,
        t=jnp.asarray(0.0), n=jnp.asarray(0),
    )
    for _ in range(3):
        s_par = step(s_par, dt)

    tol = 1e-12 if psolver == "pencil" else 1e-9  # CG reltol ~ sqrt(eps)
    diff = float(jnp.max(jnp.abs(s_par.u - s_ref.u)))
    assert diff < tol, diff


@needs8
def test_halo_cg_1d_mesh():
    n = 16
    setup = _setup3d(n)
    ps = ins.psolver_spectral(setup)
    method = ins.RKMethods.RK44()
    ug = ins.random_field(setup, kp=3, psolver=ps, rng=jax.random.PRNGKey(2))
    u0 = strip_ghosts(ug)
    dt = 5e-3
    s_ref = _ref_fast(setup, u0, dt, 3)

    mesh = make_mesh((4,), devices=jax.devices()[:4])
    step = make_halo_fast_step(setup, method, mesh, psolver="cg")
    s_par = StepperState(
        u=shard_interior(mesh, u0), temp=None,
        t=jnp.asarray(0.0), n=jnp.asarray(0),
    )
    for _ in range(3):
        s_par = step(s_par, dt)
    assert float(jnp.max(jnp.abs(s_par.u - s_ref.u))) < 1e-9


@needs8
@pytest.mark.parametrize("mshape", [(4,), (2, 2)])
@pytest.mark.parametrize("dodissipation", [False, True])
def test_halo_temperature(mshape, dodissipation):
    """Periodic Boussinesq coupling on the halo path == the ghosted
    reference stepper (strip/reghost across the layout boundary)."""
    from ins_tpu.boundary_conditions import apply_bc_temp, apply_bc_u
    from ins_tpu.ops.fastpath import reghost
    from ins_tpu.time_steppers.step import timestep

    n = 16
    tbc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    temperature = ins.temperature_equation(
        Pr=0.71, Ra=1e5, Ge=1.0, dodissipation=dodissipation,
        boundary_conditions=tbc, gdir=1, dtype=jnp.float64,
    )
    setup = _setup3d(n, temperature=temperature)
    ps = ins.psolver_spectral(setup)
    method = ins.RKMethods.RK44()
    ug = ins.random_field(setup, kp=3, psolver=ps, rng=jax.random.PRNGKey(3))
    zero = jnp.asarray(0.0, jnp.float64)
    Tg = apply_bc_temp(
        jnp.asarray(
            np.random.default_rng(4).standard_normal(setup.grid.N) * 0.1
        ),
        zero, setup,
    )
    dt = 2e-3

    # ghosted reference stepper (general path handles temperature)
    s_ref = StepperState(u=ug, temp=Tg, t=zero, n=jnp.asarray(0))
    for _ in range(3):
        s_ref = timestep(method, s_ref, jnp.asarray(dt), setup=setup,
                         psolver=ps)

    ndev = int(np.prod(mshape))
    mesh = make_mesh(mshape, devices=jax.devices()[:ndev])
    step = make_halo_fast_step(setup, method, mesh)
    D = 3
    u0 = strip_ghosts(ug)
    T0 = Tg[(slice(1, -1),) * D]
    s_par = StepperState(
        u=shard_interior(mesh, u0),
        temp=shard_scalar(mesh, T0),
        t=zero, n=jnp.asarray(0),
    )
    for _ in range(3):
        s_par = step(s_par, dt)

    du = float(jnp.max(jnp.abs(s_par.u - strip_ghosts(s_ref.u))))
    dT = float(jnp.max(jnp.abs(s_par.temp - s_ref.temp[(slice(1, -1),) * D])))
    assert du < 1e-11, du
    assert dT < 1e-11, dT


def _setup3d_f32(n=32, **kw):
    x = (np.linspace(0, 2 * np.pi, n + 1),) * 3
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    return ins.Setup(
        x=x, boundary_conditions=bc, Re=1e3, dtype=jnp.float32, **kw
    )


def _config(name, n):
    """(setup, method, with_temp, theta) of a halo test configuration."""
    tbc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    if name == "lmwray3":
        return _setup3d(n), ins.LMWray3(), False, None
    if name == "temp_bodyforce":
        te = ins.temperature_equation(
            Pr=0.71, Ra=1e5, Ge=0.5, dodissipation=True,
            boundary_conditions=tbc, gdir=2, dtype=jnp.float64,
        )
        x = (np.linspace(0, 2 * np.pi, n + 1),) * 3
        setup = ins.Setup(
            x=x, boundary_conditions=tbc, Re=1e3, temperature=te,
            bodyforce=lambda d, x, y, z, t: (d == 0) * 0.5 * jnp.sin(y),
            issteadybodyforce=True, dtype=jnp.float64,
        )
        return setup, ins.RKMethods.RK44(), True, None
    assert name == "smagorinsky"
    x = (np.linspace(0, 2 * np.pi, n + 1),) * 3
    base = _setup3d(n)
    setup = ins.Setup(
        x=x, boundary_conditions=tbc, Re=1e3,
        closure_model=ins.smagorinsky_closure_natural(base),
        dtype=jnp.float64,
    )
    return setup, ins.RKMethods.RK44(), False, jnp.asarray(0.17)


@needs8
@pytest.mark.parametrize("mshape", [(2,), (4,), (8,), (2, 2), (2, 4)])
@pytest.mark.parametrize("config", ["lmwray3", "temp_bodyforce", "smagorinsky"])
def test_halo_configs_match_fastpath(mshape, config):
    """The per-shard shift graph with LMWray3, Boussinesq temperature
    (+dissipation) with a steady body force, and the natural Smagorinsky
    closure == the single-device fast path (f64), on 1-D and 2-D meshes."""
    n = 24
    setup, m, with_temp, theta = _config(config, n)
    ps = ins.psolver_spectral(setup)
    u0 = strip_ghosts(
        ins.random_field(setup, kp=3, psolver=ps, rng=jax.random.PRNGKey(8))
    )
    T0 = None
    if with_temp:
        g = setup.grid
        xp = np.meshgrid(
            *[np.asarray(g.xp[d])[1:-1] for d in range(3)], indexing="ij"
        )
        T0 = jnp.asarray(0.1 * np.sin(xp[0]) * np.cos(xp[1]))
    dt = 2e-3
    zero = jnp.asarray(0.0)
    fast = jax.jit(make_fast_timestep(setup, m))
    s_ref = StepperState(u=u0, temp=T0, t=zero, n=jnp.asarray(0))
    for _ in range(3):
        s_ref = fast(s_ref, jnp.asarray(dt), theta)

    ndev = int(np.prod(mshape))
    mesh = make_mesh(mshape, devices=jax.devices()[:ndev])
    step = make_halo_fast_step(setup, m, mesh)
    s = StepperState(
        u=shard_interior(mesh, u0),
        temp=shard_scalar(mesh, T0) if with_temp else None,
        t=zero, n=jnp.asarray(0),
    )
    for _ in range(3):
        s = step(s, dt, theta)
    assert float(jnp.max(jnp.abs(s.u - s_ref.u))) < 1e-11
    if with_temp:
        assert float(jnp.max(jnp.abs(s.temp - s_ref.temp))) < 1e-11


@needs8
def test_halo_smagorinsky_needs_three_planes():
    """The per-shard Smagorinsky stencil reaches 3 planes: thinner
    shards are refused up front."""
    setup, m, _, _ = _config("smagorinsky", 16)
    mesh = make_mesh((8,), devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="3"):
        make_halo_fast_step(setup, m, mesh)


@needs8
def test_solve_unsteady_halo_scan_matches_step():
    """solve_unsteady(halo=True) fixed-dt scan chunks agree with per-step
    halo stepping (f32)."""
    n = 32
    setup = _setup3d_f32(n)
    ps = ins.psolver_spectral(setup)
    u0 = jax.jit(lambda k: ins.random_field(setup, kp=3, psolver=ps, rng=k))(
        jax.random.PRNGKey(12)
    )
    mesh = make_mesh((4,), devices=jax.devices()[:4])
    dt = 5e-3
    sfin, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, 4 * dt), dt=dt,
        mesh=mesh, halo=True,
    )
    step = make_halo_fast_step(setup, ins.RKMethods.RK44(), mesh)
    s = StepperState(
        u=shard_interior(mesh, strip_ghosts(u0)), temp=None,
        t=jnp.asarray(0.0, jnp.float32), n=jnp.asarray(0),
    )
    for _ in range(4):
        s = step(s, dt)
    assert (
        float(jnp.max(jnp.abs(sfin.u[:, 1:-1, 1:-1, 1:-1] - s.u))) < 1e-5
    )


@needs8
def test_solve_unsteady_halo_integration():
    """`solve_unsteady(mesh=..., halo=True)` drives the shard_map halo
    step with the full driver feature set: processors, NaN guard,
    adaptive CFL (psum'd min-reductions via GSPMD), and matches the
    single-device solve."""
    n = 16
    setup = _setup3d(n)
    ps = ins.psolver_spectral(setup)
    m = ins.RKMethods.RK44()
    ug = ins.random_field(setup, kp=3, psolver=ps, rng=jax.random.PRNGKey(11))
    mesh = make_mesh((4,), devices=jax.devices()[:4])

    # fixed dt + processors
    s_ref, out_ref = ins.solve_unsteady(
        setup=setup, ustart=ug, tlims=(0.0, 0.02), dt=2e-3, method=m,
        psolver=ps, processors={"log": ins.timelogger(nupdate=5)},
    )
    s_par, out_par = ins.solve_unsteady(
        setup=setup, ustart=ug, tlims=(0.0, 0.02), dt=2e-3, method=m,
        psolver=ps, mesh=mesh, halo=True,
        processors={"log": ins.timelogger(nupdate=5)},
    )
    assert float(jnp.max(jnp.abs(s_par.u - s_ref.u))) < 1e-11
    # public layout is ghosted and periodic
    un = np.asarray(s_par.u)
    np.testing.assert_allclose(un[:, 0], un[:, -2])

    # adaptive CFL stepping (psum'd reductions) reaches tend
    s_ad, _ = ins.solve_unsteady(
        setup=setup, ustart=ug, tlims=(0.0, 0.01), method=m,
        psolver=ps, mesh=mesh, halo=True, cfl=0.5,
    )
    assert float(s_ad.t) == pytest.approx(0.01, abs=1e-12)
    assert bool(jnp.all(jnp.isfinite(s_ad.u)))

    # NaN guard fires with the halo step too
    with pytest.raises(ins.SolverDivergedError):
        ins.solve_unsteady(
            setup=setup, ustart=jnp.full_like(ug, 1e30),
            tlims=(0.0, 0.02), dt=2e-3, method=m, psolver=ps,
            mesh=mesh, halo=True,
        )


@needs8
def test_halo_no_donation_by_default():
    """donate=False (default): the input state stays usable after a step
    (round-1 use-after-donate footgun removed)."""
    n = 16
    setup = _setup3d(n)
    ps = ins.psolver_spectral(setup)
    method = ins.RKMethods.RK44()
    ug = ins.random_field(setup, kp=3, psolver=ps, rng=jax.random.PRNGKey(5))
    u0 = strip_ghosts(ug)
    mesh = make_mesh((4,), devices=jax.devices()[:4])
    step = make_halo_fast_step(setup, method, mesh)
    s0 = StepperState(
        u=shard_interior(mesh, u0), temp=None,
        t=jnp.asarray(0.0), n=jnp.asarray(0),
    )
    s1 = step(s0, 1e-3)
    # both live: stepping twice from the same state must give the same u
    s1b = step(s0, 1e-3)
    assert float(jnp.max(jnp.abs(s1.u - s1b.u))) == 0.0
