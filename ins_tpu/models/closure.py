"""Closure-model wrapping and staggered<->collocated adapters.

Re-design of IncompressibleNavierStokes.jl
`lib/NeuralClosure/src/closure.jl`. NN tensors are batch-first NHWC
`(nsample, *nx, D)` (XLA-native conv layout); solver fields are
component-first ghosted `(D, *N)`. `wrappedclosure` adapts between them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["collocate", "decollocate", "create_closure", "wrappedclosure"]


def collocate(u):
    """Interpolate velocity components from right faces to volume centers
    (periodic): channel a averaged with its roll(+1) along axis a
    (reference closure.jl:38-72). `u`: (nsample, *nx, D)."""
    D = u.shape[-1]
    comps = []
    for a in range(D):
        v = u[..., a]
        comps.append((v + jnp.roll(v, 1, axis=1 + a)) / 2)
    return jnp.stack(comps, axis=-1)


def decollocate(u):
    """Interpolate closure force from volume centers back to faces
    (reference closure.jl:77-108)."""
    D = u.shape[-1]
    comps = []
    for a in range(D):
        v = u[..., a]
        comps.append((v + jnp.roll(v, -1, axis=1 + a)) / 2)
    return jnp.stack(comps, axis=-1)


def create_closure(module, *, rng, sample_shape, dtype=jnp.float32):
    """Initialize a flax module into `(closure, theta)` with
    `closure(x, theta)` (reference create_closure, closure.jl:22-33)."""
    x0 = jnp.zeros((1, *sample_shape), dtype)
    variables = module.init(rng, x0)
    theta = variables["params"]

    def closure(x, theta):
        return module.apply({"params": theta}, x)

    return closure, theta


def wrappedclosure(m, setup):
    """Adapt an NN closure `(nsample, *nx, D) -> (nsample, *nx, D)` to the
    solver field convention `(D, *N)` with ghost volumes
    (reference wrappedclosure, closure.jl:4-17). Periodic grids only."""
    g = setup.grid
    D = g.dim
    inside = g.Iu[0]
    assert all(box == inside for box in g.Iu), "Only periodic grids supported"
    sl = tuple(slice(s, e) for (s, e) in inside)

    def neuralclosure(u, theta):
        ui = u[(slice(None),) + sl]  # (D, *n)
        x = jnp.moveaxis(ui, 0, -1)[None]  # (1, *n, D)
        mu = m(x, theta)
        mu = jnp.moveaxis(mu[0], -1, 0)  # (D, *n)
        # Restore ghost shape with circular padding
        mu = jnp.pad(mu, [(0, 0)] + [(1, 1)] * D, mode="wrap")
        return mu

    return neuralclosure
