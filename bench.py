"""Headline benchmark: DecayingTurbulence3D, 256^3 (north star per
BASELINE.json) plus 128^3, Float32, RK44, spectral pressure projection —
the reference's de-facto performance configuration
(examples/DecayingTurbulence3D.jl:15-38; BASELINE.md).

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "extra"}.  A failing
configuration fails the run.

`vs_baseline` is measured against an assumed A100 anchor of 1.0e8
cell-updates/s/chip (the reference publishes no numbers — BASELINE.md
documents the absence; this anchor approximates an optimized CUDA run of
the same 4-stage RK + FFT-projection step).
"""

import json
import os
import subprocess
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import ins_tpu as ins
from ins_tpu.time_steppers.methods import LMWray3
from ins_tpu.time_steppers.step import create_stepper
from ins_tpu.utils.compile_cache import enable_compile_cache

BASELINE_CUPS = 1.0e8  # assumed A100-parity anchor (cell-updates/s/chip)


def card_name_and_power():
    """The first card's name and power limit as `nvidia-smi` reports them
    ("not measured" where there is no nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        return "not measured"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not measured"


def step_min_bytes(n, method, itemsize=4):
    """Least device-memory traffic of one 3-D fast-path step on an n^3
    grid, in bytes, computed from shapes.  The model: every stage is one
    fused pass that reads the velocity and its tableau base and writes
    the uncorrected velocity and the divergence; the spectral solve reads
    and writes one scalar field per FFT (two FFTs); the correction reads
    the uncorrected velocity and the potential and writes the velocity.
    Each stage that updates a low-storage accumulator (RK44's b row,
    LMWray3's running base) reads and writes one more velocity.  Stage 0
    reads no separate base (it is the velocity itself)."""
    F = n**3 * itemsize  # one scalar field
    V = 3 * F
    if isinstance(method, LMWray3):
        ns = len(method.a)
        nacc = ns - 1
    else:
        ns = method.nstage
        nacc = sum(
            1 for i in range(ns - 1) if method.A[ns - 1][i] != 0.0
        )
    per_stage = (V + V) + (V + F) + 2 * (F + F) + (V + F + V)
    return ns * per_stage + nacc * 2 * V - V


def run_case(N, nwarm, nstep, method=None, les=False):
    dtype = jnp.float32
    lims = (0.0, 2 * np.pi)
    x = tuple(np.linspace(*lims, N + 1) for _ in range(3))
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    kw = {}
    theta = None
    if les:
        # north-star LES config (BASELINE.json configs[3]): Smagorinsky
        # through the fused stage kernels + one fused closure pass/stage
        base = ins.Setup(x=x, boundary_conditions=bc, Re=4000.0, dtype=dtype)
        kw["closure_model"] = ins.smagorinsky_closure_natural(base)
        theta = jnp.asarray(0.17, dtype)
    setup = ins.Setup(
        x=x, boundary_conditions=bc, Re=4000.0, dtype=dtype, **kw
    )
    psolver = ins.psolver_spectral(setup)
    u0 = jax.jit(lambda key: ins.random_field(setup, kp=10, rng=key))(
        jax.random.PRNGKey(1)
    )

    if method is None:
        method = ins.RKMethods.RK44()
    dt = jnp.asarray(1e-3 * 128 / N, dtype)

    from ins_tpu.ops.fastpath import (
        fastpath_applicable,
        make_fast_timestep,
        strip_ghosts,
    )

    assert fastpath_applicable(setup, method, psolver)
    fast_step = make_fast_timestep(setup, method)

    # Scan chunks, exactly how solve_unsteady runs the hot loop (one
    # device dispatch per chunk, not per step).
    @partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
    def scan_steps(state, nsteps):
        def body(s, _):
            return fast_step(s, dt, theta), None

        state, _ = jax.lax.scan(body, state, None, length=nsteps)
        return state

    state = create_stepper(method, setup=setup, psolver=psolver, u=u0)
    state = state._replace(u=jax.jit(strip_ghosts)(state.u))
    # Warm with the SAME static length so the timed call reuses the
    # compiled program.
    state = scan_steps(state, nstep)
    jax.block_until_ready(state.u)

    # Best-of-3 (min) timed samples
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state = scan_steps(state, nstep)
        jax.block_until_ready(state.u)
        elapsed = min(elapsed, time.perf_counter() - t0)

    assert bool(jnp.all(jnp.isfinite(state.u))), "NaN in benchmark run"
    cups = N**3 * nstep / elapsed
    return cups, elapsed / nstep * 1e3


def run_temp_case(N, nwarm, nstep):
    """Boussinesq-coupled step time (periodic temperature riding the
    fast path) — VERDICT-r3 item 5 asks this next to the no-temp step.
    Reference treats the temperature RHS as first-class in the hot loop
    (src/time_steppers/step_explicit_runge_kutta.jl:20-28)."""
    dtype = jnp.float32
    x = tuple(np.linspace(0.0, 1.0, N + 1) for _ in range(3))
    pbc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    temperature = ins.temperature_equation(
        Pr=0.71, Ra=1e7, Ge=1.0, dodissipation=True,
        boundary_conditions=pbc, gdir=2, dtype=dtype,
    )
    setup = ins.Setup(
        x=x, boundary_conditions=pbc, temperature=temperature, dtype=dtype
    )
    psolver = ins.psolver_spectral(setup)
    u0 = jax.jit(lambda key: ins.random_field(setup, kp=10, rng=key))(
        jax.random.PRNGKey(1)
    )
    temp0 = ins.temperaturefield(
        setup, lambda xx, yy, zz: 0.5 + 0.1 * jnp.sin(2 * np.pi * xx)
    )
    dt = jnp.asarray(2e-4 * 128 / N, dtype)
    method = ins.RKMethods.RK44()

    from ins_tpu.ops.fastpath import (
        fastpath_applicable,
        make_fast_timestep,
        strip_state,
    )

    assert fastpath_applicable(setup, method, psolver)
    fast_step = make_fast_timestep(setup, method)

    @partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
    def scan_steps(state, nsteps):
        def body(s, _):
            return fast_step(s, dt, None), None

        state, _ = jax.lax.scan(body, state, None, length=nsteps)
        return state

    state = create_stepper(
        method, setup=setup, psolver=psolver, u=u0, temp=temp0
    )
    state = jax.jit(strip_state)(state)
    state = scan_steps(state, nstep)
    jax.block_until_ready(state.u)
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state = scan_steps(state, nstep)
        jax.block_until_ready(state.u)
        elapsed = min(elapsed, time.perf_counter() - t0)
    assert bool(jnp.all(jnp.isfinite(state.u)))
    assert bool(jnp.all(jnp.isfinite(state.temp)))
    return N**3 * nstep / elapsed, elapsed / nstep * 1e3


def run_solver_case(make, nstep, dt=1e-3):
    """ms/step through `solve_unsteady` for non-periodic configs (wall
    BCs, CG pressure) — the driver path a reference user hits for the
    turbulent channel (examples/TurbulentChannel.jl) and cavity."""
    setup, psolver, u0, temp0 = make()
    kw = dict(
        setup=setup, psolver=psolver, dt=dt, processors={},
        tempstart=temp0,
    )
    # warm: compiles the scan chunks for this nsteps
    state, _ = ins.solve_unsteady(
        ustart=u0, tlims=(0.0, nstep * dt), **kw
    )
    jax.block_until_ready(state.u)
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = ins.solve_unsteady(
            ustart=u0, tlims=(0.0, nstep * dt), **kw
        )
        jax.block_until_ready(state.u)
        elapsed = min(elapsed, time.perf_counter() - t0)
    assert bool(jnp.all(jnp.isfinite(state.u)))
    N = int(np.prod(setup.grid.Np))
    return N * nstep / elapsed, elapsed / nstep * 1e3


def make_channel(nx=256, ny=128, nz=128):
    """Wall-bounded turbulent channel (reference
    examples/TurbulentChannel.jl): x/y periodic, no-slip z walls,
    steady streamwise body force, stretched wall-normal grid."""
    x = (
        np.linspace(0.0, 4 * np.pi, nx + 1),
        np.linspace(0.0, 2 * np.pi, ny + 1),
        ins.tanh_grid(0.0, 2.0, nz, 1.2),
    )
    d = ins.DirichletBC()
    bc = (
        (ins.PeriodicBC(), ins.PeriodicBC()),
        (ins.PeriodicBC(), ins.PeriodicBC()),
        (d, d),
    )
    setup = ins.Setup(
        x=x, boundary_conditions=bc, Re=1e3,
        bodyforce=lambda dim, xx, yy, zz, t: (
            jnp.where(dim == 0, 1.0, 0.0) + 0.0 * xx
        ),
        issteadybodyforce=True, dtype=jnp.float32,
    )
    psolver = ins.default_psolver(setup)
    u0 = ins.velocityfield(
        setup,
        lambda dim, xx, yy, zz: jnp.where(
            dim == 0, 6.0 * zz * (2.0 - zz) / 4.0, 0.0
        ) + 0.02 * jnp.sin(2 * xx) * jnp.sin(2 * yy) * jnp.sin(np.pi * zz),
        psolver=psolver,
    )
    return setup, psolver, u0, None


def make_cavity_cg(n=128):
    """Lid-driven cavity, uniform cube, matrix-free CG pressure solve
    (VERDICT-r3 item 7; reference src/pressure.jl:251-280)."""
    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    d = ins.DirichletBC()
    lid = (1.0, 0.0, 0.0)
    bc = ((d, d), (d, d), (d, ins.DirichletBC(lid)))
    setup = ins.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=jnp.float32)
    # FDM-preconditioned CG (VERDICT-r4 item 3a): the eigen solve is the
    # exact inverse on this separable grid, so CG converges in O(1)
    # iterations instead of ~50 Jacobi-preconditioned stencil sweeps.
    psolver = ins.psolver_cg(setup, maxiter=8, reltol=1e-4, precond="fdm")
    u0 = ins.velocityfield(
        setup, lambda dim, xx, yy, zz: 0.0 * xx, psolver=psolver
    )
    return setup, psolver, u0, None


def run_gradstep_case(n=64, nunroll=5):
    """A-posteriori closure-training gradient step (north-star
    BASELINE.json configs[4]; reference
    lib/NeuralClosure/src/training.jl:116-141): grad of an nunroll
    rollout loss wrt CNN closure params, s/step."""
    import ins_tpu.models as nc
    from ins_tpu.time_steppers.rk_methods import RK44

    dtype = jnp.float32
    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    setup = ins.Setup(x=x, boundary_conditions=bc, Re=2e3, dtype=dtype)
    psolver = ins.psolver_spectral(setup)
    closure, theta = nc.cnn(
        setup=setup, radii=[2, 2, 2], channels=[24, 24, 3],
        activations=[jax.nn.tanh, jax.nn.tanh, lambda v: v],
        use_bias=[True, True, False], rng=jax.random.PRNGKey(0),
    )
    m = nc.wrappedclosure(closure, setup)
    loss = nc.create_loss_post(
        setup=setup, method=RK44(), psolver=psolver, closure_model=m,
        nsubstep=1, remat=True,
    )
    u0 = jax.jit(lambda key: ins.random_field(setup, kp=5, rng=key))(
        jax.random.PRNGKey(3)
    )
    us = jnp.stack([u0 * (1.0 - 0.01 * i) for i in range(nunroll + 1)])
    ts = jnp.arange(nunroll + 1, dtype=dtype) * 5e-4
    data = [{"u": us, "t": ts}]
    g = jax.jit(jax.grad(lambda th: loss(data, th)))
    gv = g(theta)
    jax.block_until_ready(gv)
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        gv = g(theta)
        jax.block_until_ready(gv)
        elapsed = min(elapsed, time.perf_counter() - t0)
    gn = float(jnp.sqrt(sum(jnp.sum(v**2) for v in jax.tree.leaves(gv))))
    assert np.isfinite(gn)
    return elapsed


def main():
    enable_compile_cache()
    card = card_name_and_power()
    print(f"nvidia-smi: {card}", flush=True)
    t_start = time.perf_counter()
    # Headline configs first so the JSON line is always backed by them.
    cups128, ms128 = run_case(128, 5, 20)
    cups256, ms256 = run_case(256, 5, 20)
    extra = {
        "ms_per_step_256": ms256,
        "cups_128": cups128,
        "ms_per_step_128": ms128,
        "vs_baseline_128": cups128 / BASELINE_CUPS,
    }

    # Secondary configs (LMWray3 low-storage; 512^3 single card), each
    # skipped once a wall-clock budget is spent so a fresh-compile run
    # under an external time limit still emits the headline metric.
    budget_s = float(os.environ.get("INS_BENCH_BUDGET_S", 1500))

    def extras_left():
        return time.perf_counter() - t_start < budget_s

    secondary = [
        ("256_les", lambda: run_case(256, 3, 20, les=True)),
        ("256_lmwray3", lambda: run_case(256, 3, 20, method=ins.LMWray3())),
        ("512", lambda: run_case(512, 2, 5)),
        ("512_lmwray3", lambda: run_case(512, 2, 5, method=ins.LMWray3())),
        # Boussinesq 3D, wall-bounded channel, CG cavity — each through
        # the same production entry points a reference user would hit.
        ("256_boussinesq", lambda: run_temp_case(256, 3, 10)),
        ("channel", lambda: run_solver_case(make_channel, 10)),
        ("cavity_cg128", lambda: run_solver_case(make_cavity_cg, 10)),
    ]
    for name, fn in secondary:
        if not extras_left():
            extra[f"{name}_skipped"] = "bench time budget exhausted"
            continue
        cups, ms = fn()
        extra[f"cups_{name}"] = cups
        extra[f"ms_per_step_{name}"] = ms

    # A-posteriori closure-training gradient step (s/step, lower is
    # better — not a CUPS number).
    if extras_left():
        extra["gradstep_128_s"] = run_gradstep_case(n=128, nunroll=5)
    else:
        extra["gradstep_skipped"] = "bench time budget exhausted"
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "DecayingTurbulence3D_256c_rk44_cell_updates_per_s",
                "value": cups256,
                "unit": "cell-updates/s/chip",
                "vs_baseline": cups256 / BASELINE_CUPS,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                    "card": card,
                },
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
