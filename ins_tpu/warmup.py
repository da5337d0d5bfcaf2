"""AOT warmup / smoke workload.

Equivalent of the reference's precompile workload (src/precompile.jl:2-24):
runs mini-solves across 2D/3D, float32/float64 (where supported), periodic
and Dirichlet/Pressure+temperature configurations — populating the JAX
compilation cache and doubling as an installation smoke test.

Run: `python -m ins_tpu.warmup`
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def warmup(verbose=True):
    import ins_tpu as ins
    from ins_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    results = {}
    dtypes = [jnp.float32]
    if jax.config.jax_enable_x64:
        dtypes.append(jnp.float64)

    for dtype in dtypes:
        for D in (2, 3):
            # Periodic box
            n = 8
            x = (np.linspace(0.0, 1.0, n + 1),) * D
            bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * D
            setup = ins.Setup(x=x, boundary_conditions=bc, Re=1e3, dtype=dtype)
            # jit the initializer (one dispatch instead of many eager ops)
            u0 = jax.jit(lambda k: ins.random_field(setup, kp=2, rng=k))(
                jax.random.PRNGKey(0)
            )
            state, _ = ins.solve_unsteady(
                setup=setup, ustart=u0, tlims=(0.0, 2e-3), dt=1e-3
            )
            ok = bool(jnp.all(jnp.isfinite(state.u)))
            results[f"periodic{D}d_{jnp.dtype(dtype).name}"] = ok

            # Dirichlet / Pressure outflow + temperature (2D only for speed)
            if D == 2:
                tbc = (
                    (ins.DirichletBC(1.0), ins.DirichletBC(0.0)),
                    (ins.SymmetricBC(), ins.SymmetricBC()),
                )
                temp_eq = ins.temperature_equation(
                    Pr=0.71, Ra=1e5, Ge=1.0, boundary_conditions=tbc,
                    dtype=dtype,
                )
                bc2 = (
                    (ins.DirichletBC(), ins.PressureBC()),
                    (ins.DirichletBC(), ins.DirichletBC()),
                )
                setup2 = ins.Setup(
                    x=x, boundary_conditions=bc2, temperature=temp_eq,
                    dtype=dtype,
                )
                ps = ins.psolver_cg(setup2)
                u0 = ins.velocityfield(
                    setup2, lambda d, x, y: 0.0 * x, psolver=ps
                )
                t0 = ins.temperaturefield(setup2, lambda x, y: 1.0 - x)
                state, _ = ins.solve_unsteady(
                    setup=setup2, ustart=u0, tempstart=t0,
                    tlims=(0.0, 2e-3), dt=1e-3, psolver=ps,
                )
                ok = bool(jnp.all(jnp.isfinite(state.u))) and bool(
                    jnp.all(jnp.isfinite(state.temp))
                )
                results[f"mixedbc_temp2d_{jnp.dtype(dtype).name}"] = ok

    if verbose:
        for k, v in results.items():
            print(f"  {k}: {'ok' if v else 'FAILED'}")
    assert all(results.values()), results
    return results


if __name__ == "__main__":
    warmup()
    print("warmup complete")
