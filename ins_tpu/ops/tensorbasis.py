"""Pope/Silvis symmetry tensor basis for structural closure models.

Re-design of IncompressibleNavierStokes.jl `src/tensorbasis.jl`:
B[0..2] + 2 invariants in 2D, B[0..10] + 5 invariants in 3D (Silvis2017
eqs. (9), (11)). Tensors are stacked arrays `(nb, *N, D, D)` (channel
first); the contraction `lastdimcontract` is one einsum.
Adjoints are free via JAX autodiff (the reference hand-writes the 2D
adjoint and leaves the 3D one TODO at src/tensorbasis.jl:93-95 — here both
come from the same autodiff path).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp

from ._stencil import slc
from .operators import _gradient_tensor

__all__ = ["tensorbasis", "lastdimcontract", "monitor"]

_log = logging.getLogger(__name__)


def tensorbasis(u, setup):
    """Compute (B, V): tensor basis `(nb, *N, D, D)` and invariants
    `(nv, *N)`, written on the pressure DOF box."""
    g = setup.grid
    D = g.dim
    box = g.Ip
    gu = _gradient_tensor(u, setup, box)
    G = jnp.stack([jnp.stack(row, -1) for row in gu], -2)  # (*box, D, D)
    S = (G + jnp.swapaxes(G, -1, -2)) / 2
    R = (G - jnp.swapaxes(G, -1, -2)) / 2
    eye = jnp.broadcast_to(jnp.eye(D, dtype=u.dtype), S.shape)

    def tr(x):
        return jnp.trace(x, axis1=-2, axis2=-1)

    if D == 2:
        Bs = [eye, S, S @ R - R @ S]
        Vs = [jnp.sum(S * S, (-2, -1)), jnp.sum(R * R, (-2, -1))]
    else:
        SS = S @ S
        RR = R @ R
        Bs = [
            eye,
            S,
            S @ R - R @ S,
            SS,
            RR,
            SS @ R - R @ SS,
            S @ RR + RR @ S,
            R @ S @ RR - RR @ S @ R,
            S @ R @ SS - SS @ R @ S,
            SS @ RR + RR @ SS,
            R @ SS @ RR - RR @ SS @ R,
        ]
        Vs = [tr(SS), tr(RR), tr(SS @ S), tr(S @ RR), tr(SS @ RR)]

    nb, nv = len(Bs), len(Vs)
    B = jnp.zeros((nb, *g.N, D, D), u.dtype)
    V = jnp.zeros((nv, *g.N), u.dtype)
    sl = slc(box)
    for i, b in enumerate(Bs):
        B = B.at[(i,) + sl].set(b)
    for i, v in enumerate(Vs):
        V = V.at[(i,) + sl].set(v)
    return B, V


@jax.custom_vjp
def monitor(tau):
    """Identity debug hook logging shape/dtype on the forward pass and on
    the pullback (reference `monitor`, src/tensorbasis.jl:159-167) —
    drop it into a closure chain to see what flows through AD."""
    _log.info("Forward monitor: %s %s", tau.dtype, tau.shape)
    return tau


def _monitor_fwd(tau):
    return monitor(tau), None


def _monitor_bwd(_, tbar):
    _log.info("Pullback monitor: %s %s", tbar.dtype, tbar.shape)
    return (tbar,)


monitor.defvjp(_monitor_fwd, _monitor_bwd)


def lastdimcontract(a, b):
    """c[I] = sum_i a[i, I] * b[i, I] where `a` is `(n, *N)` scalars and
    `b` is `(n, *N, D, D)` tensors (reference `lastdimcontract`,
    src/tensorbasis.jl:102-125, channel-first layout)."""
    return jnp.sum(a[..., None, None] * b, axis=0)
