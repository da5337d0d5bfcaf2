"""Field creation and synthetic-turbulence initializers.

Re-design of IncompressibleNavierStokes.jl `src/initializers.jl`: fields are
functional JAX arrays; randomness uses explicit `jax.random` keys; the
Orlandi-style spectrum initializer (`create_spectrum`, reference
src/initializers.jl:82-181) reproduces the same amplitude formula and
spectral Leray projection.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..boundary_conditions import apply_bc_temp, apply_bc_u, box_slices, plane_coords
from ._stencil import slc
from .pressure import default_psolver, project

__all__ = [
    "scalarfield",
    "vectorfield",
    "velocityfield",
    "temperaturefield",
    "create_spectrum",
    "random_field",
]


def scalarfield(setup):
    """Empty scalar field (ghosts included)."""
    return jnp.zeros(setup.grid.N, setup.dtype)


def vectorfield(setup):
    """Empty velocity field, component-first `(D, *N)`."""
    g = setup.grid
    return jnp.zeros((g.dim, *g.N), setup.dtype)


def velocityfield(setup, ufunc, t=0.0, *, psolver=None, doproject=True):
    """Divergence-free velocity field from `ufunc(alpha, *x)`
    (src/initializers.jl:13-46)."""
    g = setup.grid
    D = g.dim
    t = jnp.asarray(t, setup.dtype)
    u = vectorfield(setup)
    for a in range(D):
        box = g.Iu[a]
        coords = plane_coords(g.xu[a], box)
        val = ufunc(a, *coords) * jnp.ones(
            tuple(e - s for (s, e) in box), setup.dtype
        )
        u = u.at[(a,) + box_slices(box)].set(val)
    u = apply_bc_u(u, t, setup)
    if doproject:
        if psolver is None:
            psolver = default_psolver(setup)
        u = project(u, setup, psolver=psolver)
        u = apply_bc_u(u, t, setup)
    return u


def temperaturefield(setup, tempfunc, t=0.0):
    """Temperature field from `tempfunc(*x)` (src/initializers.jl:49-57)."""
    g = setup.grid
    t = jnp.asarray(t, setup.dtype)
    coords = plane_coords(g.xp, g.Ip)
    temp = scalarfield(setup)
    val = tempfunc(*coords) * jnp.ones(
        tuple(e - s for (s, e) in g.Ip), setup.dtype
    )
    temp = temp.at[box_slices(g.Ip)].set(val)
    return apply_bc_temp(temp, t, setup)


def create_spectrum(setup, *, kp, rng):
    """Spectral velocity amplitudes with prescribed energy profile, random
    phases, and spectral Leray projection (src/initializers.jl:82-181).

    Returns `uhat` of shape `(D, *(N - 2))` (complex).
    """
    g = setup.grid
    D = g.dim
    dtype = setup.dtype
    tau = 2 * np.pi
    N = g.N
    assert all(n % 2 == 0 for n in N), "Spectrum requires even N"
    K = tuple((n - 2) // 2 for n in N)

    def bshape(arr, d):
        return jnp.reshape(arr, tuple(-1 if i == d else 1 for i in range(D)))

    # Wavevector magnitude on the K-box
    k2 = sum(bshape(jnp.arange(K[d], dtype=dtype) ** 2, d) for d in range(D))
    k = jnp.sqrt(k2)

    # Energy profile peaked at kp
    A = (8 * tau / 3) / kp**5
    a = jnp.sqrt(A * k**4 * jnp.exp(-tau * (k / kp) ** 2)).astype(dtype)
    a = a * float(np.prod(N))
    a = a.astype(jnp.complex64 if dtype == jnp.float32 else jnp.complex128)

    keys = jax.random.split(rng, D + 2)
    xi = [
        jax.random.uniform(keys[d], K, dtype=dtype) for d in range(D)
    ]

    # Mirror to the full KK = 2K box with odd symmetry of the phase in the
    # mirrored direction
    for d in range(D):
        a = jnp.concatenate([a, jnp.flip(a, axis=d)], axis=d)
        xi = [
            jnp.concatenate(
                [x, jnp.flip((-x if b == d else x), axis=d)], axis=d
            )
            for b, x in enumerate(xi)
        ]
    phase = sum(xi)
    a = jnp.exp(1j * tau * phase) * a

    KK = tuple(2 * kd for kd in K)
    kk = [bshape(jnp.arange(KK[d], dtype=dtype), d) for d in range(D)]
    knorm2 = sum(kd**2 for kd in kk)
    knorm2 = knorm2.at[(0,) * D].set(1.0)  # origin: zero wavevector, no proj

    # Random unit vector per wavenumber
    if D == 2:
        theta = jax.random.uniform(keys[D], KK, dtype=dtype)
        e = [jnp.cos(tau * theta), jnp.sin(tau * theta)]
    else:
        theta = jax.random.uniform(keys[D], KK, dtype=dtype)
        phi = jax.random.uniform(keys[D + 1], KK, dtype=dtype)
        e = [
            jnp.sin(np.pi * theta) * jnp.cos(tau * phi),
            jnp.sin(np.pi * theta) * jnp.sin(tau * phi),
            jnp.cos(np.pi * theta),
        ]

    # Spectral Leray projection: e <- (I - k k^T/|k|^2) e, then normalize
    ke = sum(e[d] * kk[d] for d in range(D))
    e = [e[d] - kk[d] * ke / knorm2 for d in range(D)]
    enorm = jnp.sqrt(sum(ed**2 for ed in e))
    e = [ed / enorm for ed in e]

    return jnp.stack([a * ed for ed in e])


def random_field(setup, t=0.0, *, A=1.0, kp=10, psolver=None, rng=None):
    """Random turbulent velocity field (Orlandi2000 spectrum), periodic
    uniform grids only (src/initializers.jl:189-219)."""
    g = setup.grid
    D = g.dim
    if not (all(g.periodic) and all(g.uniform)):
        raise ValueError("random_field requires a uniform periodic grid")
    if rng is None:
        rng = jax.random.PRNGKey(0)
    if psolver is None:
        psolver = default_psolver(setup)
    t = jnp.asarray(t, setup.dtype)

    uhat = create_spectrum(setup, kp=kp, rng=rng)
    u = jnp.fft.ifftn(uhat, axes=tuple(range(1, D + 1)))
    u = A * jnp.real(u).astype(setup.dtype)

    # Add ghost volumes (periodic wrap)
    u = jnp.pad(u, [(0, 0)] + [(1, 1)] * D, mode="wrap")

    u = apply_bc_u(u, t, setup)
    u = project(u, setup, psolver=psolver)
    return apply_bc_u(u, t, setup)
