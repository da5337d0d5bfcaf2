"""Channel (wall-bounded) fast path: parity of the interior-layout roll
implementation against the ghosted slice graph (reference math
src/operators.jl:634-690 restricted to periodic x/y + Dirichlet z
walls)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins
from ins_tpu.ops import channelpath as cp
from ins_tpu.ops._stencil import slc


def make_setup(nx=16, ny=12, nz=10, stretched=True, lid=False,
               dtype=jnp.float64, **kw):
    x = (
        np.linspace(0.0, 4 * np.pi, nx + 1),
        np.linspace(0.0, 2 * np.pi, ny + 1),
        ins.tanh_grid(0.0, 2.0, nz, 1.3) if stretched
        else np.linspace(0.0, 2.0, nz + 1),
    )
    d = ins.DirichletBC()
    top = ins.DirichletBC((0.3, -0.2, 0.0)) if lid else d
    bc = (
        (ins.PeriodicBC(), ins.PeriodicBC()),
        (ins.PeriodicBC(), ins.PeriodicBC()),
        (d, top),
    )
    return ins.Setup(x=x, boundary_conditions=bc, Re=700.0, dtype=dtype,
                     **kw)


def random_state(setup, seed=0):
    """A BC-consistent ghosted velocity field (not div-free; fine for
    operator parity)."""
    g = setup.grid
    u = jax.random.normal(jax.random.PRNGKey(seed), (3, *g.N), setup.dtype)
    # zero non-DOF entries, then fill ghosts via the real BC path
    mask = jnp.zeros((3, *g.N), setup.dtype)
    for a in range(3):
        mask = mask.at[(a,) + slc(g.Iu[a])].set(1.0)
    u = u * mask
    return ins.apply_bc_u(u, jnp.asarray(0.0, setup.dtype), setup)


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("lid", [False, True])
def test_strip_reghost_roundtrip(stretched, lid):
    setup = make_setup(stretched=stretched, lid=lid)
    u = random_state(setup)
    ui = cp.strip_channel(u)
    ug = cp.reghost_channel(ui, setup)
    assert np.allclose(np.asarray(ug), np.asarray(u), atol=1e-14)


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("lid", [False, True])
def test_convdiff_parity(stretched, lid):
    """Interior roll conv-diff == ghosted convectiondiffusion on DOFs."""
    setup = make_setup(stretched=stretched, lid=lid)
    g = setup.grid
    met = cp.make_channel_metrics(setup)
    u = random_state(setup, seed=3)
    F_ref = ins.convectiondiffusion(u, setup)
    F_int = cp.channel_convdiff_roll(
        cp.strip_channel(u), met, 1.0 / setup.Re
    )
    F_ref_int = cp.strip_channel(F_ref)
    err = float(jnp.max(jnp.abs(F_int - F_ref_int)))
    scale = float(jnp.max(jnp.abs(F_ref_int))) + 1e-30
    assert err / scale < 1e-12, err / scale


@pytest.mark.parametrize("stretched", [False, True])
def test_divergence_parity(stretched):
    setup = make_setup(stretched=stretched)
    met = cp.make_channel_metrics(setup)
    u = random_state(setup, seed=4)
    div_ref = ins.divergence(u, setup)
    div_int = cp.channel_divergence_roll(cp.strip_channel(u), met)
    ref = div_ref[slc(setup.grid.Ip)]
    err = float(jnp.max(jnp.abs(div_int - ref)))
    assert err / (float(jnp.max(jnp.abs(ref))) + 1e-30) < 1e-12


@pytest.mark.parametrize("stretched", [False, True])
def test_correct_parity(stretched):
    setup = make_setup(stretched=stretched)
    g = setup.grid
    met = cp.make_channel_metrics(setup)
    u = random_state(setup, seed=5)
    q = jax.random.normal(jax.random.PRNGKey(6), g.N, setup.dtype)
    q = ins.apply_bc_p(q, jnp.asarray(0.0, setup.dtype), setup)
    u_ref = ins.applypressure(u, q, setup)
    u_ref = ins.apply_bc_u(u_ref, jnp.asarray(0.0, setup.dtype), setup)
    u_int = cp.channel_correct_roll(
        cp.strip_channel(u), q[slc(g.Ip)], met
    )
    ref = cp.strip_channel(u_ref)
    err = float(jnp.max(jnp.abs(u_int - ref)))
    assert err / (float(jnp.max(jnp.abs(ref))) + 1e-30) < 1e-12


def test_applicable():
    setup = make_setup()
    assert cp.channelpath_applicable(setup, ins.RKMethods.RK44())
    # periodic z -> not a channel
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    x = tuple(np.linspace(0.0, 1.0, 9) for _ in range(3))
    s2 = ins.Setup(x=x, boundary_conditions=bc, Re=100.0,
                   dtype=jnp.float64)
    assert not cp.channelpath_applicable(s2)


def _divfree_state(setup, seed=7):
    from ins_tpu.ops.fdm import psolver_fdm

    u = random_state(setup, seed)
    u = ins.project(u, setup, psolver=psolver_fdm_cached(setup))
    return ins.apply_bc_u(u, jnp.asarray(0.0, setup.dtype), setup)


_fdm_cache = {}


def psolver_fdm_cached(setup):
    from ins_tpu.ops.fdm import psolver_fdm

    key = id(setup)
    if key not in _fdm_cache:
        _fdm_cache[key] = psolver_fdm(setup, nrefine=0)
    return _fdm_cache[key]


@pytest.mark.parametrize("stretched", [False, True])
def test_channel_step_matches_ghosted(stretched):
    """3 RK44 steps: interior roll step == ghosted general stepper with
    the same FDM projection (f64)."""
    setup = make_setup(nx=12, ny=10, nz=8, stretched=stretched)
    method = ins.RKMethods.RK44()
    step = cp.make_channel_timestep(setup, method, nrefine=0)
    u0 = _divfree_state(setup)

    s_ref, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, 3e-3), dt=1e-3, method=method,
        psolver=psolver_fdm_cached(setup),
    )
    from ins_tpu.time_steppers.step import StepperState

    s = StepperState(
        u=cp.strip_channel(u0), temp=None,
        t=jnp.asarray(0.0, setup.dtype), n=0,
    )
    for _ in range(3):
        s = step(s, 1e-3, None)
    u_fast = cp.reghost_channel(s.u, setup)
    err = float(jnp.max(jnp.abs(u_fast - s_ref.u)))
    scale = float(jnp.max(jnp.abs(s_ref.u))) + 1e-30
    assert err / scale < 1e-11, err / scale


def test_channel_step_with_bodyforce():
    """Steady constant body force rides the channel step (parity vs the
    ghosted stepper)."""
    setup = make_setup(nx=12, ny=10, nz=8, stretched=True)
    import dataclasses

    setup2 = ins.Setup(
        x=(
            np.linspace(0.0, 4 * np.pi, 13),
            np.linspace(0.0, 2 * np.pi, 11),
            ins.tanh_grid(0.0, 2.0, 8, 1.3),
        ),
        boundary_conditions=setup.boundary_conditions,
        Re=700.0,
        bodyforce=lambda dim, xx, yy, zz, t: (
            jnp.where(dim == 0, 1.0, 0.0) + 0.0 * xx
        ),
        issteadybodyforce=True,
        dtype=jnp.float64,
    )
    method = ins.RKMethods.RK44()
    step = cp.make_channel_timestep(setup2, method, nrefine=0)
    u0 = _divfree_state(setup2)
    s_ref, _ = ins.solve_unsteady(
        setup=setup2, ustart=u0, tlims=(0.0, 2e-3), dt=1e-3, method=method,
        psolver=psolver_fdm_cached(setup2),
    )
    from ins_tpu.time_steppers.step import StepperState

    s = StepperState(
        u=cp.strip_channel(u0), temp=None,
        t=jnp.asarray(0.0, setup2.dtype), n=0,
    )
    for _ in range(2):
        s = step(s, 1e-3, None)
    u_fast = cp.reghost_channel(s.u, setup2)
    err = float(jnp.max(jnp.abs(u_fast - s_ref.u)))
    scale = float(jnp.max(jnp.abs(s_ref.u))) + 1e-30
    assert err / scale < 1e-11, err / scale


def test_solve_unsteady_channel_engaged():
    """solve_unsteady with the FDM psolver on a channel setup takes the
    channel fast path and matches the general (CG) stepper."""
    setup = make_setup(nx=12, ny=10, nz=8, stretched=True)
    from ins_tpu.ops.pressure import psolver_cg

    u0 = _divfree_state(setup, seed=11)
    s_ch, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, 3e-3), dt=1e-3,
        psolver=psolver_fdm_cached(setup),
    )
    s_ref, _ = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, 3e-3), dt=1e-3,
        psolver=psolver_cg(setup, reltol=1e-13),
    )
    err = float(jnp.max(jnp.abs(s_ch.u - s_ref.u)))
    scale = float(jnp.max(jnp.abs(s_ref.u))) + 1e-30
    assert err / scale < 1e-9, err / scale


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("lid", [False, True])
@pytest.mark.parametrize("bodyforce", [False, True])
def test_channel_roll_matches_ghosted_timestep(stretched, lid, bodyforce):
    """2 RK44 steps of the channel roll step == the ghosted `timestep`
    with the same FDM projection (f64), with a moving lid, a stretched
    wall-normal grid and a steady body force."""
    from ins_tpu.time_steppers.step import StepperState, timestep

    kw = {}
    if bodyforce:
        kw = dict(
            bodyforce=lambda dim, xx, yy, zz, t: (
                jnp.where(dim == 0, 1.0, 0.0) + 0.0 * xx
            ),
            issteadybodyforce=True,
        )
    setup = make_setup(nx=8, ny=6, nz=8, stretched=stretched, lid=lid, **kw)
    method = ins.RKMethods.RK44()
    assert cp.channelpath_applicable(setup, method)
    step = jax.jit(cp.make_channel_timestep(setup, method, nrefine=0))
    u0 = _divfree_state(setup, seed=13)
    ps = psolver_fdm_cached(setup)
    dt = jnp.asarray(1e-3)
    zero = jnp.asarray(0.0, setup.dtype)
    ghosted = jax.jit(
        lambda s: timestep(method, s, dt, setup=setup, psolver=ps)
    )
    s_ref = StepperState(u=u0, temp=None, t=zero, n=jnp.asarray(0))
    s = StepperState(u=cp.strip_channel(u0), temp=None, t=zero,
                     n=jnp.asarray(0))
    for _ in range(2):
        s_ref = ghosted(s_ref)
        s = step(s, dt, None)
    u_fast = cp.reghost_channel(s.u, setup)
    err = float(jnp.max(jnp.abs(u_fast - s_ref.u)))
    scale = float(jnp.max(jnp.abs(s_ref.u))) + 1e-30
    assert err / scale < 1e-11, err / scale
