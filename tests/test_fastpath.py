"""Ghost-free periodic fast path: must reproduce the ghosted reference
path through solve_unsteady."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins
from ins_tpu.ops.fastpath import fastpath_applicable
from ins_tpu.ops.pressure import psolver_cg, psolver_spectral
from ins_tpu.time_steppers.methods import ExplicitRungeKuttaMethod
from ins_tpu.time_steppers.step import StepperState, timestep


def _setup(n=32, D=2, Re=1e3, **kw):
    x = (np.linspace(0, 2 * np.pi, n + 1),) * D
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * D
    return ins.Setup(x=x, boundary_conditions=bc, Re=Re, dtype=jnp.float64, **kw)


def _u0(setup):
    return ins.random_field(setup, kp=4, rng=jax.random.PRNGKey(0))


def test_applicability():
    setup = _setup()
    ps = psolver_spectral(setup)
    assert fastpath_applicable(setup, ins.RKMethods.RK44(), ps)
    assert fastpath_applicable(setup, ins.LMWray3(), ps)
    # CG solver: not spectral -> no fast path
    assert not fastpath_applicable(setup, ins.RKMethods.RK44(), psolver_cg(setup))
    # stretched grid -> no fast path
    s2 = ins.Setup(
        x=(ins.tanh_grid(0, 1, 16),) * 2,
        boundary_conditions=((ins.DirichletBC(), ins.DirichletBC()),) * 2,
        dtype=jnp.float64,
    )
    assert not fastpath_applicable(s2, ins.RKMethods.RK44(), ps)


# Every explicit tableau of `RKMethods` plus LMWray3, by lower-case name.
EXPLICIT = [
    n for n in ins.RKMethods.__all__
    if isinstance(getattr(ins.RKMethods, n)(), ExplicitRungeKuttaMethod)
]
METHODS = {n.lower(): getattr(ins.RKMethods, n) for n in EXPLICIT}
METHODS["lmwray3"] = ins.LMWray3


def test_explicit_tableau_count():
    assert len(EXPLICIT) == 27


@pytest.mark.parametrize("method", sorted(METHODS))
def test_fastpath_matches_ghosted(method):
    """solve_unsteady on the fast path == the ghosted float64 stepper
    (`timestep` with the same spectral solve), for every explicit
    tableau and LMWray3."""
    setup = _setup(n=16)
    m = METHODS[method]()
    ps = psolver_spectral(setup)
    u0 = _u0(setup)
    dt, nstep = 1e-2, 3

    s_fast, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nstep * dt), dt=dt, method=m,
        psolver=ps,
    )

    @jax.jit
    def ghosted(u):
        s = StepperState(u=u, temp=None, t=jnp.asarray(0.0), n=jnp.asarray(0))
        for _ in range(nstep):
            s = timestep(m, s, jnp.asarray(dt), setup=setup, psolver=ps)
        return s.u

    diff = float(jnp.max(jnp.abs(s_fast.u - ghosted(u0))))
    assert diff < 1e-11, diff
    assert s_fast.u.shape == u0.shape  # public state is re-ghosted


def test_fastpath_with_bodyforce_and_closure():
    force = lambda d, x, y, t: (d == 0) * jnp.sin(2 * y)
    setup = _setup(bodyforce=force, issteadybodyforce=True)
    base = _setup()
    les = _setup(closure_model=ins.smagorinsky_closure_natural(base))
    ps = psolver_spectral(setup)
    u0 = _u0(base)

    # Bodyforce: fast (spectral) vs ghosted (CG) agree
    sf, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0, 0.02), dt=1e-2, psolver=ps
    )
    sg, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0, 0.02), dt=1e-2,
        psolver=psolver_cg(setup, reltol=1e-13),
    )
    assert float(jnp.max(jnp.abs(sf.u - sg.u))) < 1e-9

    # Closure: fast vs ghosted agree
    th = jnp.asarray(0.1, jnp.float64)
    sf, _ = ins.solve_unsteady(
        setup=les, ustart=u0, tlims=(0, 0.02), dt=1e-2, psolver=ps, theta=th
    )
    sg, _ = ins.solve_unsteady(
        setup=les, ustart=u0, tlims=(0, 0.02), dt=1e-2,
        psolver=psolver_cg(les, reltol=1e-13), theta=th,
    )
    assert float(jnp.max(jnp.abs(sf.u - sg.u))) < 1e-9


def test_fastpath_3d_and_processors():
    setup = _setup(n=16, D=3, Re=2e3)
    ps = psolver_spectral(setup)
    u0 = _u0(setup)
    saver = ins.fieldsaver(nupdate=2)
    s, out = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0, 0.04), dt=1e-2, psolver=ps,
        processors={"f": saver},
    )
    assert not np.any(np.isnan(s.u))
    assert len(out["f"]) == 2
    # Processor states are ghosted (public layout)
    assert out["f"][0]["u"].shape == u0.shape
    # Ghosts satisfy periodicity
    un = np.asarray(s.u)
    np.testing.assert_allclose(un[:, 0], un[:, -2])
    np.testing.assert_allclose(un[:, -1], un[:, 1])


def test_fastpath_adaptive_dt():
    setup = _setup(n=16)
    ps = psolver_spectral(setup)
    u0 = _u0(setup)
    s, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, 0.03), dt=None, cfl=0.5, psolver=ps
    )
    assert float(s.t) == pytest.approx(0.03, abs=1e-12)
    assert not np.any(np.isnan(s.u))


@pytest.mark.parametrize("method", ["rk44", "lmwray3"])
@pytest.mark.parametrize("dodissipation", [False, True])
def test_fastpath_temperature_matches_ghosted(method, dodissipation):
    """Boussinesq temperature on the fast path (periodic temp BCs): must
    reproduce the ghosted path, incl. the dissipation term."""
    n, D = 16, 2
    x = (np.linspace(0, 2 * np.pi, n + 1),) * D
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * D
    te = ins.temperature_equation(
        Pr=0.71, Ra=1e5, Ge=0.5, boundary_conditions=bc, gdir=1,
        dodissipation=dodissipation, dtype=jnp.float64,
    )
    setup = ins.Setup(
        x=x, boundary_conditions=bc, temperature=te, dtype=jnp.float64
    )
    m = ins.RKMethods.RK44() if method == "rk44" else ins.LMWray3()
    ps = psolver_spectral(setup)
    u0 = ins.random_field(setup, kp=3, rng=jax.random.PRNGKey(3))
    g = setup.grid
    xp = np.meshgrid(*[np.asarray(g.xp[d]) for d in range(D)], indexing="ij")
    t0 = jnp.asarray(np.sin(xp[0]) * np.cos(xp[1]), jnp.float64)

    assert fastpath_applicable(setup, m, ps)
    s_fast, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tempstart=t0, tlims=(0.0, 0.03), dt=1e-2,
        method=m, psolver=ps,
    )
    s_ref, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tempstart=t0, tlims=(0.0, 0.03), dt=1e-2,
        method=m, psolver=psolver_cg(setup, reltol=1e-13),
    )
    assert float(jnp.max(jnp.abs(s_fast.u - s_ref.u))) < 1e-9
    assert float(jnp.max(jnp.abs(s_fast.temp - s_ref.temp))) < 1e-9
    # public temp layout is re-ghosted and periodic
    tn = np.asarray(s_fast.temp)
    np.testing.assert_allclose(tn[0], tn[-2])


@pytest.mark.parametrize("method", ["RK44", "SSP22", "SSP33", "Wray3"])
@pytest.mark.parametrize("dodissipation", [False, True])
def test_fastpath_temperature_tableaus(method, dodissipation):
    """3-D Boussinesq temperature (gravity along z) on the fast path ==
    the ghosted float64 stepper, over several classic-row tableaus."""
    n, D = 8, 3
    x = (np.linspace(0, 2 * np.pi, n + 1),) * D
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * D
    te = ins.temperature_equation(
        Pr=0.71, Ra=1e5, Ge=0.5, boundary_conditions=bc, gdir=2,
        dodissipation=dodissipation, dtype=jnp.float64,
    )
    setup = ins.Setup(
        x=x, boundary_conditions=bc, temperature=te, dtype=jnp.float64
    )
    m = getattr(ins.RKMethods, method)()
    ps = psolver_spectral(setup)
    u0 = ins.random_field(setup, kp=2, rng=jax.random.PRNGKey(4))
    g = setup.grid
    xp = np.meshgrid(*[np.asarray(g.xp[d]) for d in range(D)], indexing="ij")
    t0 = jnp.asarray(np.sin(xp[0]) * np.cos(xp[1]) * np.cos(xp[2]))
    dt, nstep = 1e-2, 2

    s_fast, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tempstart=t0, tlims=(0.0, nstep * dt),
        dt=dt, method=m, psolver=ps,
    )
    s = StepperState(u=u0, temp=t0, t=jnp.asarray(0.0), n=jnp.asarray(0))
    step = jax.jit(lambda s: timestep(m, s, jnp.asarray(dt), setup=setup,
                                      psolver=ps))
    for _ in range(nstep):
        s = step(s)
    assert float(jnp.max(jnp.abs(s_fast.u - s.u))) < 1e-11
    assert float(jnp.max(jnp.abs(s_fast.temp - s.temp))) < 1e-11


@pytest.mark.parametrize("method", ["rk44", "lmwray3"])
def test_fastpath_smagorinsky_bodyforce_3d(method):
    """3-D natural-form Smagorinsky closure with a steady body force on
    the fast path == the ghosted float64 stepper."""
    force = lambda d, x, y, z, t: (d == 0) * jnp.sin(2 * y) * jnp.cos(z)
    base = _setup(n=8, D=3)
    setup = _setup(
        n=8, D=3, bodyforce=force, issteadybodyforce=True,
        closure_model=ins.smagorinsky_closure_natural(base),
    )
    m = METHODS[method]()
    ps = psolver_spectral(setup)
    u0 = _u0(base)
    th = jnp.asarray(0.17, jnp.float64)
    dt, nstep = 1e-2, 2

    assert fastpath_applicable(setup, m, ps)
    s_fast, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nstep * dt), dt=dt, method=m,
        psolver=ps, theta=th,
    )
    s = StepperState(u=u0, temp=None, t=jnp.asarray(0.0), n=jnp.asarray(0))
    step = jax.jit(lambda s: timestep(m, s, jnp.asarray(dt), setup=setup,
                                      psolver=ps, theta=th))
    for _ in range(nstep):
        s = step(s)
    assert float(jnp.max(jnp.abs(s_fast.u - s.u))) < 1e-11
