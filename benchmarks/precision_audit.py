"""Long-horizon precision audit of the float32 fast path: 5000 steps of
256^3 decaying turbulence against the same run in float64.

Records the kinetic-energy trace every 100 steps for both working
dtypes from the same initial field and prints how far they drift apart.

Usage: python benchmarks/precision_audit.py [n] [nsteps]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

import ins_tpu as ins

n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
nsteps = int(sys.argv[2]) if len(sys.argv) > 2 else 5000

jax.config.update("jax_enable_x64", True)
x = (np.linspace(0.0, 2 * np.pi, n + 1),) * 3
bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
dt = 1e-3 * 128 / n
vol = (2 * np.pi / n) ** 3


def ke(state):
    return 0.5 * vol * jnp.sum(state["u"].astype(jnp.float64) ** 2)


def run(dtype, u0):
    setup = ins.Setup(x=x, boundary_conditions=bc, Re=4000.0, dtype=dtype)
    procs = {"ke": ins.observefield(ke, nupdate=100)}
    t0 = time.time()
    state, out = ins.solve_unsteady(
        setup=setup,
        ustart=u0.astype(dtype),
        tlims=(0.0, nsteps * dt),
        dt=dt,
        processors=procs,
    )
    wall = time.time() - t0
    tr = np.asarray(out["ke"], dtype=np.float64)
    name = jnp.dtype(dtype).name
    print(f"{name}: {wall:.1f}s  KE0={tr[0]:.6e} KEend={tr[-1]:.6e}")
    return tr


setup32 = ins.Setup(x=x, boundary_conditions=bc, Re=4000.0,
                    dtype=jnp.float32)
u0 = jax.jit(lambda k: ins.random_field(setup32, kp=10, rng=k))(
    jax.random.PRNGKey(7)
)
tr32 = run(jnp.float32, u0)
tr64 = run(jnp.float64, u0)
m = min(len(tr32), len(tr64))
tr32, tr64 = tr32[:m], tr64[:m]
rel = np.abs(tr32 - tr64) / np.abs(tr64)
print(json.dumps({
    "n": n, "nsteps": nsteps, "dt": dt,
    "ke_rel_max": float(rel.max()),
    "ke_rel_final": float(rel[-1]),
    "ke_decay_f64": float(tr64[-1] / tr64[0]),
    "ke_decay_f32": float(tr32[-1] / tr32[0]),
}))
