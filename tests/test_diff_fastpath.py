"""Differentiable fast path: reverse mode through `make_fast_timestep`
(a plain roll graph + FFT projection) against the ghosted slice-graph
solver — the reference validates its hand-written Enzyme adjoints the
same way (test/chainrules.jl, src/operators.jl:1621-1910) — and the
`create_loss_post` training route that steps through it."""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins


def _rand(shape, seed, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape), dtype)


def _setup3(n=8, dtype=jnp.float32, **kw):
    x = (np.linspace(0.0, 1.0, n + 1),) * 3
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    return ins.Setup(x=x, boundary_conditions=bc, Re=50.0, dtype=dtype, **kw)


@pytest.mark.parametrize(
    "methodname",
    ["RK44", "LMWray3", "FE11", "SSP22", "SSP33", "SSP43", "Wray3",
     "RK56", "DOPRI6", "HEM5", "NSSP53", "rSSPs3"],
)
def test_fast_step_grad_matches_ghosted(methodname):
    """End-to-end: grad through the fast step == grad through the ghosted
    slice-graph timestep, as functions of the interior velocity (f64)."""
    from ins_tpu.ops.fastpath import make_fast_timestep, reghost, strip_ghosts
    from ins_tpu.time_steppers.step import StepperState, timestep

    from ins_tpu.time_steppers.methods import LMWray3

    setup = _setup3(dtype=jnp.float64)
    method = (
        LMWray3() if methodname == "LMWray3"
        else getattr(ins.RKMethods, methodname)()
    )
    psolver = ins.psolver_spectral(setup)
    dt = 1e-3
    fast = make_fast_timestep(setup, method)
    u0 = strip_ghosts(
        jax.jit(lambda k: ins.random_field(setup, kp=2, rng=k))(
            jax.random.PRNGKey(0)
        )
    )
    w = _rand(u0.shape, 12, jnp.float64)
    t0 = jnp.asarray(0.0, jnp.float64)

    def loss_fast(ui):
        s = StepperState(u=ui, temp=None, t=t0, n=jnp.asarray(0))
        return jnp.vdot(fast(s, dt, None).u, w)

    def loss_ghost(ui):
        s = StepperState(u=reghost(ui), temp=None, t=t0, n=jnp.asarray(0))
        out = timestep(method, s, dt, setup=setup, psolver=psolver)
        return jnp.vdot(strip_ghosts(out.u), w)

    vf, gf = jax.jit(jax.value_and_grad(loss_fast))(u0)
    vg, gg = jax.jit(jax.value_and_grad(loss_ghost))(u0)
    assert abs(float(vf - vg)) < 1e-10 * max(1.0, abs(float(vg)))
    scale = float(jnp.max(jnp.abs(gg)))
    assert float(jnp.max(jnp.abs(gf - gg))) < 1e-10 * max(1.0, scale)


def test_loss_post_fastpath_grads():
    """`create_loss_post` routes through the fast path on
    periodic-uniform setups; its theta-gradient matches the ghosted
    slice-graph unroll."""
    from ins_tpu.models import cnn, create_loss_post, wrappedclosure
    from ins_tpu.models.training import _unrolled_errors, _with_closure

    setup = _setup3(dtype=jnp.float64)
    nn_closure, theta0 = cnn(
        setup=setup,
        radii=(2,),
        channels=(3,),
        activations=(lambda x: x,),
        use_bias=(False,),
        rng=jax.random.PRNGKey(3),
    )
    # create_loss_post takes a SOLVER-convention closure (ghosted (D, *Np)
    # fields), per the reference convention (examplerun.jl:104-156 passes
    # wrappedclosure(closure, setup) as closure_model).
    closure = wrappedclosure(nn_closure, setup)
    psolver = ins.psolver_spectral(setup)
    method = ins.RKMethods.RK44()
    # tiny two-snapshot trajectory
    u0 = jax.jit(lambda k: ins.random_field(setup, kp=2, rng=k))(
        jax.random.PRNGKey(1)
    )
    u1 = jax.jit(lambda k: ins.random_field(setup, kp=2, rng=k))(
        jax.random.PRNGKey(2)
    )
    data = [dict(u=jnp.stack([u0, u1]), t=jnp.asarray([0.0, 1e-2]))]
    loss = create_loss_post(
        setup=setup, method=method, psolver=psolver, closure_model=closure
    )
    val, grads = jax.value_and_grad(lambda th: loss(data, th))(theta0)
    assert np.isfinite(float(val))

    # ghosted reference unroll: disable the fast dispatch by stepping
    # directly through `timestep` with the closured setup
    from ins_tpu.time_steppers.step import StepperState, timestep

    setup_c = _with_closure(setup, closure)
    g = setup.grid
    sl = (slice(None),) + tuple(slice(s, e) for (s, e) in g.Iu[0])

    def loss_ghost(th):
        state = StepperState(
            u=data[0]["u"][0], temp=None,
            t=jnp.asarray(0.0, setup.dtype), n=jnp.asarray(0),
        )
        state = timestep(
            method, state, 1e-2, setup=setup_c, psolver=psolver, theta=th
        )
        a = jnp.sum((state.u[sl] - data[0]["u"][1][sl]) ** 2)
        b = jnp.sum(data[0]["u"][1][sl] ** 2)
        return a / b

    vg, gg = jax.value_and_grad(loss_ghost)(theta0)
    assert abs(float(val - vg)) < 1e-8 * max(1.0, abs(float(vg)))
    flat_f, _ = jax.flatten_util.ravel_pytree(grads)
    flat_g, _ = jax.flatten_util.ravel_pytree(gg)
    scale = float(jnp.max(jnp.abs(flat_g)))
    assert float(jnp.max(jnp.abs(flat_f - flat_g))) < 1e-6 * max(1.0, scale)
