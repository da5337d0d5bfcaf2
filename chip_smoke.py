"""Smoke test of the periodic-DNS main path on one NVIDIA GPU.

Drives 3-D decaying turbulence (the reference's DecayingTurbulence3D,
float32, `psolver_spectral`) through `ins.solve_unsteady`, the entry
point users call, and checks it on the card:

- `env`:  JAX version, device, XLA flags, compile-cache directory, and the
          card's name and power limit (from `nvidia-smi`);
- `fft`:  float32 real-FFT round trip and periodic Poisson solve at 256^3
          against float64 on the card;
- `main`: 256^3, RK44, 5 steps with a time logger and an energy observer,
          compared with the ghosted slice-graph stepper in float64 from the
          same start; energy decay; ms/step over 20-step scan chunks;
- `big`:  512^3, LMWray3, 3 steps: finite, divergence-free, ms/step.

`--four` instead runs the explicitly sharded path
(`solve_unsteady(mesh=..., halo=True)`) on four cards, on the x-slab mesh
(4,) and the pencil mesh (2, 2), each against the single-card fast path.

Every phase either passes or stops the script with a non-zero exit code.
Numbers go to standard output as one JSON object per line; the last line
is `{"ok": true, "device": {...}}`.

Run: python chip_smoke.py [--four]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import jax

SEED = 0


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_info():
    """Name and power limit of each card, as `nvidia-smi` reports them (a
    child process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    check(lines, "nvidia-smi listed no card")
    return lines


def block(x):
    return jax.block_until_ready(x)


def peak_bytes(dev):
    return int(dev.memory_stats()["peak_bytes_in_use"])


def timed_solves(solve, nrep):
    """Warm-up call (compile; excluded), then `nrep` timed calls; each
    ends in `block_until_ready`.  Returns (first_s, [seconds...])."""
    t0 = time.perf_counter()
    block(solve())
    first = time.perf_counter() - t0
    times = []
    for _ in range(nrep):
        t0 = time.perf_counter()
        block(solve())
        times.append(time.perf_counter() - t0)
    return first, times


def timing(first, times, nstep, ncell, card):
    med = statistics.median(times)
    return dict(
        card=card,
        ms_per_step_median=med / nstep * 1e3,
        ms_per_step_min=min(times) / nstep * 1e3,
        ms_per_step_max=max(times) / nstep * 1e3,
        repeats=len(times),
        cell_updates_per_s=ncell * nstep / med,
        compile_s=first - med,
    )


def periodic_setup(ins, n, dtype):
    import numpy as np

    x = (np.linspace(0.0, 2 * np.pi, n + 1),) * 3
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    return ins.Setup(x=x, boundary_conditions=bc, Re=4000.0, dtype=dtype)


def initial_field(ins, setup, key):
    ps = ins.psolver_spectral(setup)
    return jax.jit(lambda k: ins.random_field(setup, kp=10, psolver=ps, rng=k))(
        jax.random.PRNGKey(key)
    )


def rel_l2(a, b):
    import jax.numpy as jnp

    a = a.astype(jnp.float64)
    b = b.astype(jnp.float64)
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


def rel_max(a, b):
    import jax.numpy as jnp

    a = a.astype(jnp.float64)
    b = b.astype(jnp.float64)
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))


def div_residual(ins, u, setup64):
    """max |div u| relative to max|u| / dx, on the interior (float64)."""
    import jax.numpy as jnp
    import numpy as np

    from ins_tpu.ops._stencil import slc

    u64 = u.astype(jnp.float64)
    div = ins.divergence(u64, setup64)[slc(setup64.grid.Ip)]
    dx = float(np.asarray(setup64.grid.delta[0])[0])
    return float(jnp.max(jnp.abs(div)) * dx / jnp.max(jnp.abs(u64)))


def step_cost(ins, setup, method, u_ghost):
    """Bytes accessed by one compiled fast-path step (XLA's cost
    analysis) beside the shape-computed minimum."""
    import jax.numpy as jnp

    from bench import step_min_bytes
    from ins_tpu.ops.fastpath import make_fast_timestep, strip_ghosts
    from ins_tpu.time_steppers.step import StepperState

    step = make_fast_timestep(setup, method)
    s = StepperState(
        u=jax.ShapeDtypeStruct(strip_ghosts(u_ghost).shape, setup.dtype),
        temp=None,
        t=jax.ShapeDtypeStruct((), setup.dtype),
        n=jax.ShapeDtypeStruct((), jnp.int32),
    )
    dt = jax.ShapeDtypeStruct((), setup.dtype)
    compiled = jax.jit(step).lower(s, dt, None).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    n = int(setup.grid.Np[0])
    return dict(
        bytes_accessed_per_step=float(ca.get("bytes accessed", float("nan"))),
        min_bytes_per_step=float(step_min_bytes(n, method)),
    )


def phase_fft(ins, card, n=256):
    import jax.numpy as jnp
    import numpy as np

    from ins_tpu.ops.pressure import spectral_inverse_laplacian

    dx = 2 * np.pi / n
    vol = dx**3
    f64 = jax.random.normal(jax.random.PRNGKey(SEED + 1), (n,) * 3, jnp.float64)
    f64 = f64 - jnp.mean(f64)
    f32 = f64.astype(jnp.float32)
    inv = spectral_inverse_laplacian((n,) * 3, (dx,) * 3)

    rt = jax.jit(lambda f: jnp.fft.irfftn(jnp.fft.rfftn(f), f.shape))
    roundtrip = rel_l2(rt(f32), f32)

    def solve(f, m):
        return jnp.fft.irfftn(jnp.fft.rfftn(f) * m, f.shape).astype(f.dtype)

    solve = jax.jit(solve)
    p32 = solve(f32, jnp.asarray(inv, jnp.float32))
    p64 = solve(f64, jnp.asarray(inv, jnp.float64))
    p_err = rel_l2(p32, p64)

    @jax.jit
    def residual(p, f):
        p = p.astype(jnp.float64)
        lap = sum(
            jnp.roll(p, -1, d) - 2 * p + jnp.roll(p, 1, d) for d in range(3)
        ) * (vol / dx**2)
        return jnp.linalg.norm(lap - f) / jnp.linalg.norm(f)

    res32 = float(residual(p32, f64))
    res64 = float(residual(p64, f64))
    # float32 FFTs keep O(eps32 * log n) ~ 1e-7 relative error; 1e-6
    # leaves a decade for the card's transform order.  The Poisson solve
    # error and residual inherit the same rounding.
    tol = dict(roundtrip=1e-6, poisson_rel_err=1e-5, poisson_residual=1e-5)
    emit("fft", n=n, card=card, roundtrip_rel_l2=roundtrip,
         poisson_rel_err_vs_f64=p_err, poisson_residual_f32=res32,
         poisson_residual_f64=res64, tolerances=tol)
    check(roundtrip <= tol["roundtrip"], f"fft round trip {roundtrip}")
    check(p_err <= tol["poisson_rel_err"], f"poisson error {p_err}")
    check(res32 <= tol["poisson_residual"], f"poisson residual {res32}")


def phase_main(ins, card, dev, n=256, nstep=5, dt=5e-4, ntime=20):
    import jax.numpy as jnp

    from ins_tpu.time_steppers.step import StepperState, timestep

    setup = periodic_setup(ins, n, jnp.float32)
    setup64 = periodic_setup(ins, n, jnp.float64)
    method = ins.RKMethods.RK44()
    ps = ins.psolver_spectral(setup)
    u0 = initial_field(ins, setup, SEED)

    energy = ins.observefield(
        lambda s: float(ins.total_kinetic_energy(s["u"], setup))
    )
    state, out = ins.solve_unsteady(
        setup=setup, ustart=u0, tlims=(0.0, nstep * dt), dt=dt,
        method=method, psolver=ps,
        processors={"log": ins.timelogger(), "energy": energy},
    )
    u = block(state.u)
    check(int(state.n) == nstep, f"main: took {int(state.n)} steps")
    check(bool(jnp.all(jnp.isfinite(u))), "main: non-finite velocity")
    e = out["energy"]
    e0 = float(ins.total_kinetic_energy(u0, setup))
    # no forcing, energy-conserving convection: viscosity only removes
    # energy, so every step lowers it
    decays = all(b < a for a, b in zip([e0] + e[:-1], e))

    # warm (compiles the 20-step chunk), then timed repeats
    first, times = timed_solves(
        lambda: ins.solve_unsteady(
            setup=setup, ustart=u, tlims=(0.0, ntime * dt), dt=dt,
            method=method, psolver=ps,
        )[0].u,
        5,
    )
    peak_fast = peak_bytes(dev)
    cost = step_cost(ins, setup, method, u0)

    # plain reference: the ghosted slice-graph stepper in float64
    ps64 = ins.psolver_spectral(setup64)
    dt64 = jnp.asarray(dt, jnp.float64)

    @jax.jit
    def reference(u):
        s = StepperState(u=u, temp=None, t=jnp.asarray(0.0, jnp.float64),
                         n=jnp.asarray(0))
        s = jax.lax.fori_loop(
            0, nstep,
            lambda i, s: timestep(method, s, dt64, setup=setup64, psolver=ps64),
            s,
        )
        return s.u

    uref = block(reference(u0.astype(jnp.float64)))
    inner = (slice(None),) + (slice(1, -1),) * 3
    err_l2 = rel_l2(u[inner], uref[inner])
    err_max = rel_max(u[inner], uref[inner])
    div = div_residual(ins, u, setup64)
    # float32 rounding over 5 RK44 steps (20 stencil + FFT passes) gives
    # ~1e-6 relative; the path has no matrix product, so no TF32 enters.
    tol = dict(rel_l2=1e-5, rel_max=1e-4, div=1e-5)
    emit("main", n=n, method="RK44", steps=nstep, dt=dt,
         rel_l2_vs_f64_ghosted=err_l2, rel_max_vs_f64_ghosted=err_max,
         div_residual=div, energy=[e0] + e, energy_decays=decays,
         tolerances=tol, peak_bytes_in_use=peak_fast, **cost,
         **timing(first, times, ntime, n**3, card))
    check(err_l2 <= tol["rel_l2"], f"main: rel L2 error {err_l2}")
    check(err_max <= tol["rel_max"], f"main: rel max error {err_max}")
    check(div <= tol["div"], f"main: divergence residual {div}")
    check(decays, f"main: energy does not decay: {[e0] + e}")


def phase_big(ins, card, dev, n=512, nstep=3):
    import jax.numpy as jnp

    dt = 1e-3 * 128 / n
    setup = periodic_setup(ins, n, jnp.float32)
    setup64 = periodic_setup(ins, n, jnp.float64)
    method = ins.LMWray3()
    ps = ins.psolver_spectral(setup)
    u0 = initial_field(ins, setup, SEED)
    res = {}

    def solve():
        res["state"] = ins.solve_unsteady(
            setup=setup, ustart=u0, tlims=(0.0, nstep * dt), dt=dt,
            method=method, psolver=ps,
        )[0]
        return res["state"].u

    first, times = timed_solves(solve, 3)
    u = res["state"].u
    check(int(res["state"].n) == nstep, "big: wrong step count")
    finite = bool(jnp.all(jnp.isfinite(u)))
    div = div_residual(ins, u, setup64)
    peak = peak_bytes(dev)
    cost = step_cost(ins, setup, method, u0)
    emit("big", n=n, method="LMWray3", steps=nstep, dt=dt, finite=finite,
         div_residual=div, peak_bytes_in_use=peak, **cost,
         **timing(first, times, nstep, n**3, card))
    check(finite, "big: non-finite velocity")
    check(div <= 1e-5, f"big: divergence residual {div}")


def phase_four(ins, card, n=512, nstep=3):
    """The explicitly sharded path on 4 cards against the single-card
    fast path on device 0, from the same start."""
    import jax.numpy as jnp

    from ins_tpu.parallel import make_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    dt = 1e-3 * 128 / n
    setup = periodic_setup(ins, n, jnp.float32)
    method = ins.RKMethods.RK44()
    ps = ins.psolver_spectral(setup)
    with jax.default_device(devs[0]):
        u0 = initial_field(ins, setup, SEED)
    kw = dict(setup=setup, tlims=(0.0, nstep * dt), dt=dt, method=method,
              psolver=ps)
    res = {}

    def single():
        res["ref"] = ins.solve_unsteady(ustart=u0, **kw)[0].u
        return res["ref"]

    first, times = timed_solves(single, 3)
    uref = res["ref"]
    emit("four", mesh="single", devices=[str(d) for d in uref.devices()],
         **timing(first, times, nstep, n**3, card))
    inner = (slice(None),) + (slice(1, -1),) * 3
    # both runs are float32 with the same stencils; only the FFT
    # decomposition (pencil transposes vs one 3-D cuFFT) differs
    tol = 1e-5
    for shape in ((4,), (2, 2)):
        mesh = make_mesh(shape, devices=devs)

        def sharded():
            res["u"] = ins.solve_unsteady(
                ustart=u0, mesh=mesh, halo=True, halo_psolver="pencil", **kw
            )[0].u
            return res["u"]

        first, times = timed_solves(sharded, 3)
        u = res["u"]
        err = rel_l2(u[inner], uref[inner])
        spread = len(u.sharding.device_set)
        emit("four", mesh=list(shape), sharding=str(u.sharding),
             devices_holding_result=spread, rel_l2_vs_single=err,
             tolerance=tol, **timing(first, times, nstep, n**3, card))
        check(bool(jnp.all(jnp.isfinite(u))), f"{shape}: non-finite")
        check(err <= tol, f"{shape}: rel L2 {err} vs the single card")
        check(spread == 4, f"{shape}: result sits on {spread} device(s)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded halo path on 4 cards only")
    args = ap.parse_args()

    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"no GPU: JAX's first device is {dev.platform!r}")
    jax.config.update("jax_enable_x64", True)  # for the float64 references

    import ins_tpu as ins
    from ins_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    cards = card_info()
    card = cards[0]
    print(f"nvidia-smi: {card}", flush=True)
    emit("env", jax=jax.__version__, device_kind=dev.device_kind,
         device_count=len(jax.devices()),
         xla_flags=os.environ.get("XLA_FLAGS", ""),
         compile_cache_dir=cache_dir, cards=cards)

    if args.four:
        phase_four(ins, card)
    else:
        phase_fft(ins, card)
        phase_main(ins, card, dev)
        phase_big(ins, card, dev)

    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
