"""Boussinesq temperature overhead on the fast path: 3D periodic
Rayleigh-Benard step timings with and without the temperature equation.

Usage: python benchmarks/temp_probe.py [n_bench]
"""

import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

import ins_tpu as ins  # noqa: E402
from ins_tpu.ops import fastpath as fp  # noqa: E402
from ins_tpu.time_steppers.step import StepperState  # noqa: E402


def make_setup(n, with_temp=True, dtype=jnp.float32):
    x = tuple(np.linspace(0.0, 1.0, n + 1) for _ in range(3))
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    kw = {}
    if with_temp:
        kw["temperature"] = ins.temperature_equation(
            Pr=0.71, Ra=1e7, Ge=1.0, dodissipation=True,
            boundary_conditions=bc, gdir=2, dtype=dtype,
        )
    return ins.Setup(
        x=x, boundary_conditions=bc, Re=4000.0, dtype=dtype, **kw
    )


def initial_state(setup, n):
    u0 = jax.jit(
        lambda key: ins.random_field(setup, kp=5, rng=key)
    )(jax.random.PRNGKey(1))
    u0 = fp.strip_ghosts(u0)
    xs = np.linspace(0.0, 1.0, n, endpoint=False)
    t0 = jnp.asarray(
        0.5
        + 0.1 * np.sin(2 * np.pi * xs)[:, None, None]
        * np.ones((n, n, n)),
        setup.dtype,
    )
    return StepperState(
        u=u0, temp=t0, t=jnp.asarray(0.0, setup.dtype), n=0
    )


def bench(n=256, nstep=10, with_temp=True):
    setup = make_setup(n, with_temp=with_temp)
    m = ins.RKMethods.RK44()
    s0 = initial_state(setup, n)
    if not with_temp:
        s0 = s0._replace(temp=None)
    dt = jnp.asarray(2e-4 * 128 / n, setup.dtype)
    step = fp.make_fast_timestep(setup, m)

    @partial(jax.jit, static_argnums=(1,), donate_argnums=(0,))
    def scan_steps(s, k):
        s, _ = jax.lax.scan(
            lambda si, _: (step(si, dt, None), None), s, None, length=k
        )
        return s

    s = scan_steps(s0, nstep)
    jax.block_until_ready(s.u)
    el = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        s = scan_steps(s, nstep)
        jax.block_until_ready(s.u)
        el = min(el, time.perf_counter() - t0)
    assert bool(jnp.all(jnp.isfinite(s.u)))
    if with_temp:
        assert bool(jnp.all(jnp.isfinite(s.temp)))
    tag = "RB (temp)" if with_temp else "no-temp  "
    print(
        f"{tag} n={n}: "
        f"{el / nstep * 1e3:.2f} ms/step "
        f"({n**3 * nstep / el:.3e} CUPS)"
    )
    return el / nstep * 1e3


if __name__ == "__main__":
    n_b = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    ms_t = bench(n_b, with_temp=True)
    ms_0 = bench(n_b, with_temp=False)
    print(f"temp overhead at {n_b}^3: {ms_t / ms_0:.3f}x")
