"""Smagorinsky eddy-viscosity closures.

Two forms, as in the reference:

- **Natural-position form** (preferred; IncompressibleNavierStokes.jl
  `src/eddyviscosity.jl:1-183`): strain components live as D(D+1)/2 scalar
  fields at their natural staggered positions — structure-of-arrays, no
  tensor-valued elements, which XLA fuses into loop kernels.
- **Pressure-point form** (`smagorinsky_closure`, reference
  src/operators.jl:1135-1305): full DxD stress tensor at pressure points
  with BC fill and interpolated tensor divergence.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..boundary_conditions import apply_bc_p
from ._stencil import seg, slc, take, take2
from .operators import _gradient_tensor

__all__ = [
    "strain_natural",
    "smagorinsky_viscosity",
    "apply_eddy_viscosity",
    "divoftensor_natural",
    "smagorinsky_closure_natural",
    "smagorinsky_natural_interior",
    "smagorinsky_closure",
    "divoftensor",
]


# Periodic-ghost wrap for intermediate fields (the reference never fills
# strain/viscosity/stress ghosts — src/eddyviscosity.jl kernels write Ip
# only — so its shifted reads at periodic edges see stale zeros; see
# operators.wrap_periodic_ghosts).
from .operators import wrap_periodic_ghosts as _wrap_ghosts

# Natural strain component order: 2D (xx, yy, xy); 3D (xx, yy, zz, xy, xz, yz)
_PAIRS = {2: [(0, 0), (1, 1), (0, 1)], 3: [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]}


def strain_natural(u, setup):
    """Strain-rate components at natural staggered positions
    (src/eddyviscosity.jl:9-46). Returns dict keyed by (a, b) index pairs
    over full-N arrays (written on Ip)."""
    g = setup.grid
    D = g.dim
    box = g.Ip

    # Diagonal: du_a/dx_a at pressure points, width = delta_u[a][I_a]
    # (verbatim reference widths)
    def ddiag(a):
        return (take(u[a], box) - take(u[a], box, a, -1)) / seg(
            g.delta_u[a], box, a
        )

    # Off-diagonal (a < b): (du_a/dx_b + du_b/dx_a)/2 at the a-b edge,
    # widths delta[b] and delta[a] respectively
    def doff(a, b):
        dab = (take(u[a], box, b, +1) - take(u[a], box)) / seg(
            g.delta[b], box, b
        )
        dba = (take(u[b], box, a, +1) - take(u[b], box)) / seg(
            g.delta[a], box, a
        )
        return (dab + dba) / 2

    S = {}
    for (a, b) in _PAIRS[D]:
        val = ddiag(a) if a == b else doff(a, b)
        full = jnp.zeros(g.N, u.dtype)
        S[(a, b)] = full.at[slc(box)].set(val)
    return S


def smagorinsky_viscosity(S, theta, setup):
    """Eddy viscosity θ²d²√(2 S:S) with off-diagonal components averaged
    from the 4 surrounding edges (src/eddyviscosity.jl:56-79)."""
    g = setup.grid
    D = g.dim
    box = g.Ip
    d2 = 0.0
    for d in range(D):
        d2 = d2 + seg(g.delta[d], box, d) ** 2
    acc = 0.0
    for (a, b) in _PAIRS[D]:
        sab = S[(a, b)]
        if a == b:
            acc = acc + 2 * take(sab, box) ** 2
        else:
            avg4 = (
                take(sab, box) ** 2
                + take(sab, box, a, -1) ** 2
                + take(sab, box, b, -1) ** 2
                + take2(sab, box, a, -1, b, -1) ** 2
            ) / 4
            acc = acc + 4 * avg4
    visc = theta**2 * d2 * jnp.sqrt(acc)
    full = jnp.zeros(g.N, S[(0, 0)].dtype)
    return full.at[slc(box)].set(visc)


def apply_eddy_viscosity(S, visc, setup):
    """sigma = 2 nu_t S, off-diagonal viscosity averaged to edge positions
    (src/eddyviscosity.jl:89-114)."""
    g = setup.grid
    box = g.Ip
    out = {}
    for (a, b) in _PAIRS[g.dim]:
        sab = S[(a, b)]
        if a == b:
            v = take(visc, box)
        else:
            v = (
                take(visc, box)
                + take(visc, box, a, +1)
                + take(visc, box, b, +1)
                + take2(visc, box, a, +1, b, +1)
            ) / 4
        full = jnp.zeros(g.N, sab.dtype)
        out[(a, b)] = full.at[slc(box)].set(2 * v * take(sab, box))
    return out


def divoftensor_natural(sigma, setup):
    """Divergence of a natural-position symmetric tensor onto velocity
    points (src/eddyviscosity.jl:124-156)."""
    g = setup.grid
    D = g.dim
    box = g.Ip
    c = jnp.zeros((D, *g.N), sigma[(0, 0)].dtype)

    def comp(a, b):
        return sigma[(min(a, b), max(a, b))]

    for a in range(D):
        acc = 0.0
        for b in range(D):
            s = comp(a, b)
            if a == b:
                acc = acc + (take(s, box, a, +1) - take(s, box)) / seg(
                    g.delta_u[a], box, a
                )
            else:
                acc = acc + (take(s, box) - take(s, box, b, -1)) / seg(
                    g.delta[b], box, b
                )
        c = c.at[(a,) + slc(box)].set(acc)
    return c


def smagorinsky_closure_natural(setup):
    """Build the natural-form Smagorinsky closure `m(u, θ)`
    (src/eddyviscosity.jl:158-183).  Ghosts of the intermediate
    strain/viscosity/stress fields are wrapped on periodic dimensions
    (see `_wrap_ghosts`); the returned closure is tagged with
    ``kind = "smagorinsky_natural"`` so the uniform-periodic fast path
    can swap in its ghost-free roll twin."""

    def closure(u, theta):
        S = strain_natural(u, setup)
        S = {k: _wrap_ghosts(v, setup) for k, v in S.items()}
        visc = _wrap_ghosts(smagorinsky_viscosity(S, theta, setup), setup)
        sigma = apply_eddy_viscosity(S, visc, setup)
        sigma = {k: _wrap_ghosts(v, setup) for k, v in sigma.items()}
        return divoftensor_natural(sigma, setup)

    closure.kind = "smagorinsky_natural"
    return closure


def smagorinsky_natural_interior(u, theta, dxs):
    """Natural-form Smagorinsky on ghost-free *uniform periodic* interior
    fields (the fast-path layout; any D): same math as
    `smagorinsky_closure_natural` with every stencil shift a circular
    roll."""
    D = u.shape[0]

    def rp(v, d):
        return jnp.roll(v, -1, axis=d)

    def rm(v, d):
        return jnp.roll(v, 1, axis=d)

    S = {}
    for a in range(D):
        S[(a, a)] = (u[a] - rm(u[a], a)) / dxs[a]
        for b in range(a + 1, D):
            S[(a, b)] = 0.5 * (
                (rp(u[a], b) - u[a]) / dxs[b] + (rp(u[b], a) - u[b]) / dxs[a]
            )
    d2 = sum(dx * dx for dx in dxs)
    acc = 0.0
    for a in range(D):
        acc = acc + 2.0 * S[(a, a)] ** 2
        for b in range(a + 1, D):
            s = S[(a, b)]
            acc = acc + (
                s**2 + rm(s, a) ** 2 + rm(s, b) ** 2 + rm(rm(s, a), b) ** 2
            )
    nu = theta**2 * d2 * jnp.sqrt(acc)
    sig = {}
    for a in range(D):
        sig[(a, a)] = 2.0 * nu * S[(a, a)]
        for b in range(a + 1, D):
            nue = (nu + rp(nu, a) + rp(nu, b) + rp(rp(nu, a), b)) / 4
            sig[(a, b)] = 2.0 * nue * S[(a, b)]
    out = []
    for a in range(D):
        c = 0.0
        for b in range(D):
            s = sig[(min(a, b), max(a, b))]
            if a == b:
                c = c + (rp(s, a) - s) / dxs[a]
            else:
                c = c + (s - rm(s, b)) / dxs[b]
        out.append(c)
    return jnp.stack(out)


# --------------------------------------------------------------------------
# Pressure-point (full-tensor) form
# --------------------------------------------------------------------------


def _smagtensor(u, theta, setup):
    """Stress tensor sigma = 2 nu_t S at pressure points, stacked as
    (*N, D, D) (reference smagtensor!, src/operators.jl:1135-1151)."""
    g = setup.grid
    D = g.dim
    box = g.Ip
    gu = _gradient_tensor(u, setup, box)
    G = jnp.stack([jnp.stack(row, -1) for row in gu], -2)
    S = (G + jnp.swapaxes(G, -1, -2)) / 2
    d2 = 0.0
    for d in range(D):
        d2 = d2 + seg(g.delta[d], box, d) ** 2
    ss = jnp.sum(S * S, axis=(-2, -1))
    eddyvisc = theta**2 * d2 * jnp.sqrt(2 * ss)
    sig = 2 * eddyvisc[..., None, None] * S
    full = jnp.zeros((*g.N, D, D), u.dtype)
    return full.at[slc(box)].set(sig)


def divoftensor(sigma, setup):
    """Divergence of a pressure-point tensor field onto velocity points
    (reference divoftensor!, src/operators.jl:1166-1238)."""
    g = setup.grid
    D = g.dim
    out = jnp.zeros((D, *g.N), sigma.dtype)
    for a in range(D):
        box = g.Iu[a]
        acc = 0.0
        for b in range(D):
            sab = sigma[..., a, b]
            if a == b:
                s2 = take(sab, box, b, +1)
                s1 = take(sab, box)
                dl = seg(g.delta_u[b], box, b)
            else:
                s2 = (
                    take(sab, box)
                    + take(sab, box, b, +1)
                    + take2(sab, box, a, +1, b, +1)
                    + take(sab, box, a, +1)
                ) / 4
                s1 = (
                    take(sab, box, b, -1)
                    + take(sab, box)
                    + take2(sab, box, a, +1, b, -1)
                    + take(sab, box, a, +1)
                ) / 4
                dl = seg(g.delta[b], box, b)
            acc = acc + (s2 - s1) / dl
        out = out.at[(a,) + slc(box)].set(acc)
    return out


def smagorinsky_closure(setup):
    """Pressure-point Smagorinsky closure `m(u, θ)` with BC fill on the
    stress tensor (reference src/operators.jl:1294-1305)."""
    zero = jnp.asarray(0.0, setup.dtype)

    def closure(u, theta):
        sigma = _smagtensor(u, theta, setup)
        sigma = apply_bc_p(sigma, zero, setup)
        return divoftensor(sigma, setup)

    return closure
