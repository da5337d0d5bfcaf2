"""Benchmark suite (BASELINE.md contract): prints one JSON line per case.

Cases:
- DecayingTurbulence3D 128^3 and 256^3 (f32, RK44, spectral) — throughput
- TaylorGreenVortex2D accuracy (L2 error + convergence order)
- LidDrivenCavity2D (Dirichlet + CG) — wall-clock per step
- RayleighBenard2D (Ra=1e7 Boussinesq) — wall-clock per step
- A-posteriori closure-training step (grad through unrolled solver)

Run: `python benchmarks/run_benchmarks.py [--quick]`
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def bench_decaying3d(n, nstep=20):
    import jax
    import jax.numpy as jnp

    import ins_tpu as ins
    from ins_tpu.ops.fastpath import make_fast_timestep, strip_ghosts
    from ins_tpu.time_steppers.step import create_stepper

    x = (np.linspace(0, 2 * np.pi, n + 1),) * 3
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    setup = ins.Setup(x=x, boundary_conditions=bc, Re=4e3, dtype=jnp.float32)
    psolver = ins.psolver_spectral(setup)
    u0 = jax.jit(lambda k: ins.random_field(setup, kp=10, rng=k))(
        jax.random.PRNGKey(1)
    )
    method = ins.RKMethods.RK44()
    fast = make_fast_timestep(setup, method)
    dt = jnp.asarray(1e-3, jnp.float32)

    from functools import partial

    @partial(jax.jit, donate_argnums=(0,))
    def step(s):
        return fast(s, dt, None)

    s = create_stepper(method, setup=setup, psolver=psolver, u=u0)
    s = s._replace(u=jax.jit(strip_ghosts)(s.u))
    for _ in range(5):
        s = step(s)
    jax.block_until_ready(s.u)
    t0 = time.perf_counter()
    for _ in range(nstep):
        s = step(s)
    jax.block_until_ready(s.u)
    el = (time.perf_counter() - t0) / nstep
    assert bool(jnp.all(jnp.isfinite(s.u)))
    emit(
        metric=f"decaying_turbulence_3d_{n}c_rk44",
        value=n**3 / el,
        unit="cell-updates/s/chip",
        ms_per_step=el * 1e3,
    )


def bench_tgv2d():
    import os

    import jax.numpy as jnp

    sys.path.insert(
        0, os.path.join(os.path.dirname(__file__), "..", "examples")
    )
    from taylor_green_vortex_2d import compute_convergence

    # f32 (the production dtype); accuracy floor is then ~1e-4
    errs = compute_convergence((32, 64, 128), dtype=jnp.float32)
    rates = [float(np.log2(errs[i] / errs[i + 1])) for i in range(len(errs) - 1)]
    emit(
        metric="tgv2d_l2_error_n128",
        value=errs[-1],
        unit="relative L2",
        convergence_rates=rates,
    )


def _solve_time(setup, u0, temp0, psolver, dt, nstep):
    import jax

    import ins_tpu as ins

    def run():
        state, _ = ins.solve_unsteady(
            setup=setup, ustart=u0, tempstart=temp0, tlims=(0, nstep * dt),
            dt=dt, psolver=psolver,
        )
        jax.block_until_ready(state.u)

    run()  # warm: compiles the scan at this exact static length
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) / nstep


def bench_cavity(n=128, nstep=20):
    import jax.numpy as jnp

    import ins_tpu as ins

    x = (ins.cosine_grid(0.0, 1.0, n),) * 2
    bc = (
        (ins.DirichletBC(), ins.DirichletBC()),
        (ins.DirichletBC(), ins.DirichletBC((1.0, 0.0))),
    )
    setup = ins.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=jnp.float32)
    for label, ps in (
        ("fdm", ins.psolver_fdm(setup)),
        ("cg", ins.psolver_cg(setup)),
    ):
        u0 = ins.velocityfield(setup, lambda d, x, y: 0.0 * x, psolver=ps)
        el = _solve_time(setup, u0, None, ps, 1e-3, nstep)
        emit(
            metric=f"lid_driven_cavity_2d_{n}c_rk44_{label}",
            value=el * 1e3,
            unit="ms/step",
        )


def bench_rayleigh_benard(n=64, nstep=20):
    import jax.numpy as jnp

    import ins_tpu as ins

    temperature = ins.temperature_equation(
        Pr=0.71, Ra=1e7, Ge=1.0,
        boundary_conditions=(
            (ins.SymmetricBC(), ins.SymmetricBC()),
            (ins.DirichletBC(1.0), ins.DirichletBC(0.0)),
        ),
        gdir=1, dtype=jnp.float32,
    )
    x = (ins.tanh_grid(0, 2, 2 * n, 1.2), ins.tanh_grid(0, 1, n, 1.2))
    d = ins.DirichletBC()
    setup = ins.Setup(
        x=x, boundary_conditions=((d, d), (d, d)), temperature=temperature,
        dtype=jnp.float32,
    )
    ps = ins.psolver_fdm(setup)
    u0 = ins.velocityfield(setup, lambda dim, x, y: 0.0 * x, psolver=ps)
    t0 = ins.temperaturefield(setup, lambda x, y: 1 - y)
    el = _solve_time(setup, u0, t0, ps, 5e-4, nstep)
    emit(
        metric=f"rayleigh_benard_2d_{2*n}x{n}_ra1e7_fdm",
        value=el * 1e3,
        unit="ms/step",
    )


def bench_training_step(n=64):
    import jax
    import jax.numpy as jnp

    import ins_tpu as ins
    import ins_tpu.models as nc
    from ins_tpu.time_steppers.rk_methods import RK44

    les = ins.Setup(
        x=(np.linspace(0, 1, n + 1),) * 2,
        boundary_conditions=((ins.PeriodicBC(), ins.PeriodicBC()),) * 2,
        Re=2e3, dtype=jnp.float32,
    )
    closure, theta = nc.cnn(
        setup=les, radii=[2, 2], channels=[24, 2],
        activations=[jax.nn.tanh, lambda x: x], use_bias=[True, False],
        rng=jax.random.PRNGKey(0),
    )
    m = nc.wrappedclosure(closure, les)
    ps = ins.psolver_spectral(les)
    loss = nc.create_loss_post(
        setup=les, method=RK44(), psolver=ps, closure_model=m
    )
    u = jax.jit(lambda k: ins.random_field(les, kp=8, rng=k))(
        jax.random.PRNGKey(1)
    )
    traj = [dict(
        u=jnp.stack([u] * 6),
        t=jnp.arange(6, dtype=jnp.float32) * 1e-3,
    )]
    g = jax.jit(jax.grad(lambda th: loss(traj, th)))
    r = g(theta)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(5):
        r = g(theta)
    jax.block_until_ready(r)
    el = (time.perf_counter() - t0) / 5
    emit(
        metric=f"aposteriori_training_step_{n}c_unroll5",
        value=el * 1e3,
        unit="ms/grad-step",
    )


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--skip-256", action="store_true")
    args = p.parse_args()

    bench_decaying3d(32 if args.quick else 128)
    if not (args.quick or args.skip_256):
        bench_decaying3d(256, nstep=10)
    bench_tgv2d()
    bench_cavity(32 if args.quick else 128)
    bench_rayleigh_benard(16 if args.quick else 64)
    bench_training_step(32 if args.quick else 64)
