"""Production-scale decaying turbulence (3D, up to 512^3 on one GPU).

The production configuration this framework is built around, in one
script: the low-storage LMWray3 stepper (3 stages per step — 55.2 ms/step
at 512^3 on one H100 at a 400 W power limit, docs/manual/performance.md),
Orbax async checkpointing (non-blocking background writes, resumable),
in-scan NaN guard, and decimated spectrum/energy observers.  Reference analogue: the DecayingTurbulence3D
case (examples/DecayingTurbulence3D.jl) scaled to production size.

Run: python examples/production_turbulence_3d.py [--n 512]
"""

import jax
import jax.numpy as jnp
import numpy as np

import ins_tpu as ins


def run(quick=False, outdir=None, n=None):
    n = n or (16 if quick else 256)
    tend = 0.01 if quick else 1.0
    dt = 1e-3 * 128 / max(n, 128)
    x = (np.linspace(0.0, 2 * np.pi, n + 1),) * 3
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * 3
    setup = ins.Setup(x=x, boundary_conditions=bc, Re=4e3, dtype=jnp.float32)
    psolver = ins.psolver_spectral(setup)
    u0 = jax.jit(
        lambda k: ins.random_field(
            setup, kp=5 if quick else 10, psolver=psolver, rng=k
        )
    )(jax.random.PRNGKey(0))

    nstep = max(1, int(round(tend / dt)))
    procs = {
        "log": ins.timelogger(nupdate=max(1, nstep // 10)),
        "energy": ins.observefield(
            lambda s: (
                float(s["t"]),
                float(ins.total_kinetic_energy(s["u"], setup)),
            ),
            nupdate=max(1, nstep // 20),
        ),
    }
    if outdir is not None:
        # Orbax async checkpointing: background-thread writes, managed
        # retention; resume via ins.load_async_checkpoint(outdir)
        procs["ckpt"] = ins.async_checkpointer(
            str(outdir), nupdate=max(1, nstep // 4), keep_last=2
        )

    state, out = ins.solve_unsteady(
        setup=setup,
        ustart=u0,
        tlims=(0.0, tend),
        dt=dt,
        method=ins.LMWray3(),
        psolver=psolver,
        processors=procs,
    )
    E = out["energy"]
    energies = [e for _, e in E]
    return {
        "state": state,
        "outputs": out,
        "finite": all(np.isfinite(e) for e in energies),
        "decaying": energies[-1] <= energies[0],
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args()
    run(n=args.n, outdir=args.outdir)
    print("done")
