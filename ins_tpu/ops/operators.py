"""Differential operators on the staggered grid.

Re-design of IncompressibleNavierStokes.jl `src/operators.jl`
(1910 LoC of KernelAbstractions kernels + hand-written adjoint kernels).
Here every operator is a pure function built from static-slice stencil
arithmetic which XLA fuses; adjoints come for free from JAX autodiff (the
reference's hand-written adjoint kernels serve as gradient ground truth in
`tests/test_chainrules.py`).

Fields: velocity `u: (D, *N)` (component-first), scalars
`(N...)`. All shapes include ghost volumes; operators write only the DOF
boxes `Iu[alpha]` / `Ip` of their output, boundary values are filled
separately by `apply_bc_*` (same contract as reference src/operators.jl:29-33).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ._stencil import seg, slc, take, take2

__all__ = [
    "scalewithvolume",
    "divergence",
    "pressuregradient",
    "applypressure",
    "laplacian",
    "convection",
    "diffusion",
    "convectiondiffusion",
    "convection_diffusion_temp",
    "dissipation",
    "dissipation_from_strain",
    "applybodyforce",
    "gravity",
    "momentum",
    "vorticity",
    "interpolate_u_p",
    "interpolate_omega_p",
    "kinetic_energy",
    "total_kinetic_energy",
    "Dfield",
    "Qfield",
    "eig2field",
    "get_scale_numbers",
]


def _volume(setup, box):
    """Volume sizes Omega_I over `box` (broadcast product of widths)."""
    g = setup.grid
    om = seg(g.delta[0], box, 0)
    for d in range(1, g.dim):
        om = om * seg(g.delta[d], box, d)
    return om


def scalewithvolume(p, setup):
    """Scale scalar field with volume sizes (reference src/operators.jl:64-78)."""
    g = setup.grid
    D = g.dim
    full = tuple((0, n) for n in g.N)
    out = p
    for d in range(D):
        out = out * seg(g.delta[d], full, d)
    return out


# --------------------------------------------------------------------------
# Divergence / gradient / projection pieces
# --------------------------------------------------------------------------


def divergence(u, setup):
    """Divergence of velocity at pressure points (src/operators.jl:106-125)."""
    g = setup.grid
    box = g.Ip
    acc = 0.0
    for a in range(g.dim):
        acc = acc + (take(u[a], box) - take(u[a], box, a, -1)) / seg(
            g.delta[a], box, a
        )
    div = jnp.zeros(g.N, u.dtype)
    return div.at[slc(box)].set(acc)


def pressuregradient(p, setup):
    """Pressure gradient on velocity points (src/operators.jl:159-178)."""
    g = setup.grid
    G = jnp.zeros((g.dim, *g.N), p.dtype)
    for a in range(g.dim):
        box = g.Iu[a]
        val = (take(p, box, a, +1) - take(p, box)) / seg(g.delta_u[a], box, a)
        G = G.at[(a,) + slc(box)].set(val)
    return G


def applypressure(u, p, setup):
    """Subtract pressure gradient from `u` (src/operators.jl:214-233)."""
    g = setup.grid
    for a in range(g.dim):
        box = g.Iu[a]
        val = (take(p, box, a, +1) - take(p, box)) / seg(g.delta_u[a], box, a)
        u = u.at[(a,) + slc(box)].add(-val)
    return u


def laplacian(p, setup):
    """Volume-scaled, BC-aware pressure Laplacian (src/operators.jl:297-364).

    Uses the precomputed per-dimension row coefficients `grid.lap_c`
    (boundary rows modified for Dirichlet/Pressure BCs exactly as the
    reference's `lapα!` kernel).
    """
    g = setup.grid
    box = g.Ip
    om = _volume(setup, box)
    acc = 0.0
    for d in range(g.dim):
        cl, cc, cr = g.lap_c[d]
        D_ = len(box)
        shape = [1] * D_
        shape[d] = box[d][1] - box[d][0]
        cl = jnp.reshape(cl, shape)
        cc = jnp.reshape(cc, shape)
        cr = jnp.reshape(cr, shape)
        part = (
            cr * take(p, box, d, +1)
            + cc * take(p, box)
            + cl * take(p, box, d, -1)
        )
        acc = acc + om / seg(g.delta[d], box, d) * part
    L = jnp.zeros(g.N, p.dtype)
    return L.at[slc(box)].set(acc)


# --------------------------------------------------------------------------
# Convection / diffusion
# --------------------------------------------------------------------------


def _convdiff_component(u, setup, a, *, do_conv, do_diff, visc=None):
    """Convection and/or diffusion flux divergence for component `a` over
    box Iu[a]. Skew-symmetric convective form with face-interpolation
    weights A (reference convection_diffusion_kernel!,
    src/operators.jl:647-690)."""
    g = setup.grid
    D = g.dim
    box = g.Iu[a]
    eps2 = 2 * float(np.finfo(setup.dtype).eps)
    f = 0.0
    for b in range(D):
        dlt = g.delta_u[b] if a == b else g.delta[b]
        div_b = seg(dlt, box, b)
        if do_conv:
            A1, A2 = g.A[b][a]
            u_c = take(u[a], box)
            u_mb = take(u[a], box, b, -1)
            u_pb = take(u[a], box, b, +1)
            uab1 = (u_mb + u_c) / 2
            uab2 = (u_c + u_pb) / 2
            # u[b] interpolated to the corners of the u[a] control volume
            # (weight arrays indexed along dim a)
            w2m = seg(A2, box, a, -1 if a == b else 0)
            w1m = seg(A1, box, a, 0 if a == b else +1)
            w2c = seg(A2, box, a)
            w1c = seg(A1, box, a, +1)
            uba1 = w2m * take(u[b], box, b, -1) + w1m * take2(
                u[b], box, b, -1, a, +1
            )
            uba2 = w2c * take(u[b], box) + w1c * take(u[b], box, a, +1)
            f = f - (uab2 * uba2 - uab1 * uba1) / div_b
        if do_diff:
            da = (
                seg(g.delta[b], box, b)
                if b == a
                else seg(g.delta_u[b], box, b, -1)
            )
            db = (
                seg(g.delta[b], box, b, +1)
                if b == a
                else seg(g.delta_u[b], box, b)
            )
            d_lo = (take(u[a], box) - take(u[a], box, b, -1)) / da
            d_hi = (take(u[a], box, b, +1) - take(u[a], box)) / db
            # eps-guard: zero derivatives across infinitely thin ghost
            # volumes (reference src/operators.jl:563-567)
            d_lo = jnp.where(da > eps2, d_lo, 0.0)
            d_hi = jnp.where(db > eps2, d_hi, 0.0)
            f = f + visc * (d_hi - d_lo) / div_b
    return box, f


def convection(u, setup):
    """Convective term −∇·(u uᵀ) on velocity points (src/operators.jl:378-415)."""
    F = jnp.zeros_like(u)
    for a in range(setup.grid.dim):
        box, f = _convdiff_component(u, setup, a, do_conv=True, do_diff=False)
        F = F.at[(a,) + slc(box)].add(f)
    return F


def diffusion(u, setup, *, use_viscosity=True):
    """Diffusive term ν∇²u on velocity points (src/operators.jl:537-573)."""
    visc = 1 / setup.Re if use_viscosity else jnp.asarray(1.0, setup.dtype)
    F = jnp.zeros_like(u)
    for a in range(setup.grid.dim):
        box, f = _convdiff_component(
            u, setup, a, do_conv=False, do_diff=True, visc=visc
        )
        F = F.at[(a,) + slc(box)].add(f)
    return F


def convectiondiffusion(u, setup):
    """Fused convection + diffusion (src/operators.jl:634-690). The hot
    kernel of the solver; single fused slice-arithmetic graph per
    component."""
    visc = 1 / setup.Re
    F = jnp.zeros_like(u)
    for a in range(setup.grid.dim):
        box, f = _convdiff_component(
            u, setup, a, do_conv=True, do_diff=True, visc=visc
        )
        F = F.at[(a,) + slc(box)].add(f)
    return F


# --------------------------------------------------------------------------
# Temperature equation terms (Boussinesq)
# --------------------------------------------------------------------------


def _avg(phi, delta_d, box, d, shift=0):
    """delta-weighted average of scalar phi in direction d
    (reference `avg`, src/operators.jl:59-62), at I+shift*e_d."""
    d0 = seg(delta_d, box, d, shift)
    d1 = seg(delta_d, box, d, shift + 1)
    return (d1 * take(phi, box, d, shift) + d0 * take(phi, box, d, shift + 1)) / (
        d0 + d1
    )


def convection_diffusion_temp(u, temp, setup):
    """Temperature convection-diffusion (src/operators.jl:711-735)."""
    g = setup.grid
    box = g.Ip
    a4 = setup.temperature.alpha4
    acc = 0.0
    for b in range(g.dim):
        dT1 = (take(temp, box) - take(temp, box, b, -1)) / seg(
            g.delta_u[b], box, b, -1
        )
        dT2 = (take(temp, box, b, +1) - take(temp, box)) / seg(
            g.delta_u[b], box, b
        )
        uT1 = take(u[b], box, b, -1) * _avg(temp, g.delta[b], box, b, -1)
        uT2 = take(u[b], box) * _avg(temp, g.delta[b], box, b, 0)
        acc = acc + (-(uT2 - uT1) + a4 * (dT2 - dT1)) / seg(g.delta[b], box, b)
    out = jnp.zeros(g.N, temp.dtype)
    return out.at[slc(box)].set(acc)


def wrap_periodic_ghosts(f, setup):
    """Fill the ghost planes of every *periodic* dimension of a full-N
    field (trailing dims spatial) by wrapping, gather-style.

    Used where the reference reads stale zero ghosts of an intermediate
    field at periodic edges (dissipation's diffusion interpolation,
    src/operators.jl:796-806; the natural-Smagorinsky strain/viscosity/
    stress sweeps): on a torus the consistent staggered form wraps, which
    also makes the ghosted paths agree exactly with the ghost-free fast
    paths.  Non-periodic dimensions are left untouched."""
    g = setup.grid
    for d in range(g.dim):
        if not g.periodic[d]:
            continue
        n = g.N[d]
        idx = np.arange(n)
        idx[0] = n - 2
        idx[-1] = 1
        f = jnp.take(f, jnp.asarray(idx), axis=f.ndim - g.dim + d)
    return f


def dissipation(u, setup):
    """Dissipation term of the temperature equation
    (src/operators.jl:787-808): Re·α1/γ · interpolation of u ⊙ diffusion(u)
    to pressure points (diffusion ghosts wrapped on periodic dims)."""
    g = setup.grid
    t = setup.temperature
    diff = wrap_periodic_ghosts(diffusion(u, setup), setup)
    box = g.Ip
    coef = setup.Re * t.alpha1 / t.gamma
    acc = 0.0
    for b in range(g.dim):
        acc = acc + (
            take(u[b], box, b, -1) * take(diff[b], box, b, -1)
            + take(u[b], box) * take(diff[b], box)
        ) / 2
    out = jnp.zeros(g.N, u.dtype)
    return out.at[slc(box)].set(coef * acc)


def dissipation_from_strain(u, setup):
    """Dissipation 2ν⟨S:S⟩ from the strain-rate tensor
    (src/operators.jl:821-837)."""
    g = setup.grid
    visc = 1 / setup.Re
    box = g.Ip
    gu = _gradient_tensor(u, setup, box)
    acc = 0.0
    D = g.dim
    for i in range(D):
        for j in range(D):
            S = (gu[i][j] + gu[j][i]) / 2
            acc = acc + S * S
    out = jnp.zeros(g.N, u.dtype)
    return out.at[slc(box)].set(2 * visc * acc)


def applybodyforce(u, t, setup):
    """Body force field (src/operators.jl:840-879). Steady body forces are
    precomputed in `Setup`; unsteady ones are evaluated on the full
    staggered coordinates."""
    g = setup.grid
    if setup.issteadybodyforce:
        return setup.bodyforce_field
    comps = []
    full = tuple((0, n) for n in g.N)
    for a in range(g.dim):
        coords = tuple(seg(g.xu[a][b], full, b) for b in range(g.dim))
        comps.append(
            setup.bodyforce(a, *coords, t) * jnp.ones(g.N, setup.dtype)
        )
    return jnp.stack(comps)


def gravity(temp, setup):
    """Buoyancy term α2·avg(temp) in the gravity direction
    (src/operators.jl:916-931)."""
    g = setup.grid
    tq = setup.temperature
    gdir = tq.gdir
    box = g.Iu[gdir]
    val = tq.alpha2 * _avg(temp, g.delta[gdir], box, gdir, 0)
    F = jnp.zeros((g.dim, *g.N), temp.dtype)
    return F.at[(gdir,) + slc(box)].set(val)


def momentum(u, temp, t, setup):
    """RHS of the momentum equation except pressure gradient
    (src/operators.jl:937-976): fused convection-diffusion + body force
    + buoyancy + closure-free."""
    F = convectiondiffusion(u, setup)
    if setup.bodyforce is not None or setup.bodyforce_field is not None:
        F = F + applybodyforce(u, t, setup)
    if temp is not None:
        F = F + gravity(temp, setup)
    return F


# --------------------------------------------------------------------------
# Derived fields
# --------------------------------------------------------------------------


def vorticity(u, setup):
    """Vorticity: scalar (2D) or vector (3D) (src/operators.jl:989-1021)."""
    g = setup.grid
    D = g.dim
    box = tuple((0, n - 1) for n in g.N)
    if D == 2:
        w = (take(u[1], box, 0, +1) - take(u[1], box)) / seg(
            g.delta_u[0], box, 0
        ) - (take(u[0], box, 1, +1) - take(u[0], box)) / seg(g.delta_u[1], box, 1)
        out = jnp.zeros(g.N, u.dtype)
        return out.at[slc(box)].set(w)
    out = jnp.zeros((D, *g.N), u.dtype)
    for a, ap, am in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        w = (take(u[am], box, ap, +1) - take(u[am], box)) / seg(
            g.delta_u[ap], box, ap
        ) - (take(u[ap], box, am, +1) - take(u[ap], box)) / seg(
            g.delta_u[am], box, am
        )
        out = out.at[(a,) + slc(box)].set(w)
    return out


def interpolate_u_p(u, setup):
    """Interpolate velocity to pressure points (src/operators.jl:1311-1326)."""
    g = setup.grid
    box = g.Ip
    out = jnp.zeros((g.dim, *g.N), u.dtype)
    for a in range(g.dim):
        val = (take(u[a], box, a, -1) + take(u[a], box)) / 2
        out = out.at[(a,) + slc(box)].set(val)
    return out


def interpolate_omega_p(w, setup):
    """Interpolate vorticity to pressure points (src/operators.jl:1336-1372)."""
    g = setup.grid
    D = g.dim
    box = g.Ip
    if D == 2:
        out = jnp.zeros(g.N, w.dtype)
        val = (take2(w, box, 0, -1, 1, -1) + take(w, box)) / 2
        return out.at[slc(box)].set(val)
    out = jnp.zeros((D, *g.N), w.dtype)
    for a in range(D):
        ap = (a + 1) % D
        am = (a - 1) % D
        val = (take2(w[a], box, ap, -1, am, -1) + take(w[a], box)) / 2
        out = out.at[(a,) + slc(box)].set(val)
    return out


def kinetic_energy(u, setup, *, interpolate_first=False):
    """Kinetic-energy field at pressure points (src/operators.jl:1516-1545)."""
    g = setup.grid
    box = g.Ip
    acc = 0.0
    if interpolate_first:
        for a in range(g.dim):
            s = take(u[a], box) + take(u[a], box, a, -1)
            acc = acc + s * s
        acc = acc / 8
    else:
        for a in range(g.dim):
            acc = acc + take(u[a], box) ** 2 + take(u[a], box, a, -1) ** 2
        acc = acc / 4
    out = jnp.zeros(g.N, u.dtype)
    return out.at[slc(box)].set(acc)


def total_kinetic_energy(u, setup, **kwargs):
    """Volume-integrated kinetic energy (src/operators.jl:1551-1556)."""
    g = setup.grid
    k = kinetic_energy(u, setup, **kwargs)
    k = scalewithvolume(k, setup)
    return jnp.sum(k[slc(g.Ip)])


# --------------------------------------------------------------------------
# Velocity-gradient tensor and criterion fields
# --------------------------------------------------------------------------


def _dx(u, setup, box, a, b):
    """∂u[a]/∂x[b] at pressure points over `box`
    (reference `∂x`, src/operators.jl:1023-1033)."""
    g = setup.grid
    if a == b:
        return (take(u[a], box) - take(u[a], box, b, -1)) / seg(
            g.delta[b], box, b
        )
    du = g.delta_u[b]
    d_hi = seg(du, box, b)
    d_lo = seg(du, box, b, -1)
    return (
        (take(u[a], box, b, +1) - take(u[a], box)) / d_hi
        + (take2(u[a], box, a, -1, b, +1) - take(u[a], box, a, -1)) / d_hi
        + (take(u[a], box) - take(u[a], box, b, -1)) / d_lo
        + (take(u[a], box, a, -1) - take2(u[a], box, a, -1, b, -1)) / d_lo
    ) / 4


def _gradient_tensor(u, setup, box):
    """Full velocity gradient ∇u at pressure points: gu[a][b] = ∂u[a]/∂x[b]."""
    D = setup.grid.dim
    return [[_dx(u, setup, box, a, b) for b in range(D)] for a in range(D)]


def Dfield(p, setup, *, eps=None):
    """Low-pressure vortex criterion D = |∇p| / (2 ∇²p)
    (src/operators.jl:1390-1423)."""
    g = setup.grid
    if eps is None:
        eps = float(np.finfo(setup.dtype).eps)
    G = pressuregradient(p, setup)
    box = g.Ip
    gsum = 0.0
    lap = 0.0
    for a in range(g.dim):
        gc = take(G[a], box)
        gm = take(G[a], box, a, -1)
        gsum = gsum + (gm + gc) ** 2
        lap = lap + (gc - gm) / seg(g.delta[a], box, a)
    lap = jnp.where(lap > 0, jnp.maximum(lap, eps), jnp.minimum(lap, -eps))
    out = jnp.zeros(g.N, p.dtype)
    return out.at[slc(box)].set(jnp.sqrt(gsum) / 2 / lap)


def Qfield(u, setup):
    """Q-criterion (src/operators.jl:1441-1460)."""
    g = setup.grid
    box = g.Ip
    q = 0.0
    for a in range(g.dim):
        for b in range(g.dim):
            q = q - (
                (take(u[a], box) - take(u[a], box, b, -1))
                / seg(g.delta[b], box, b)
                * (take(u[b], box) - take(u[b], box, a, -1))
                / seg(g.delta[a], box, a)
                / 2
            )
    out = jnp.zeros(g.N, u.dtype)
    return out.at[slc(box)].set(q)


def _eigvals2_sym3(M):
    """Middle eigenvalue of a batched symmetric 3x3 matrix via the
    closed-form trigonometric formula — elementwise on device (no LAPACK)
    and is robust for degenerate spectra."""
    a00, a01, a02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    a11, a12, a22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    q = (a00 + a11 + a22) / 3
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6, 0.0))
    psafe = jnp.where(p > 0, p, 1.0)
    b00, b11, b22 = (a00 - q) / psafe, (a11 - q) / psafe, (a22 - q) / psafe
    b01, b02, b12 = a01 / psafe, a02 / psafe, a12 / psafe
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = jnp.clip(detb / 2, -1.0, 1.0)
    phi = jnp.arccos(r) / 3
    e1 = q + 2 * p * jnp.cos(phi)  # largest
    e3 = q + 2 * p * jnp.cos(phi + 2 * np.pi / 3)  # smallest
    e2 = 3 * q - e1 - e3  # middle
    return jnp.where(p > 0, e2, q)


def eig2field(u, setup):
    """λ₂ vortex criterion: second eigenvalue of S²+R² (3D only)
    (src/operators.jl:1471-1489)."""
    g = setup.grid
    assert g.dim == 3, "eig2 only implemented in 3D"
    box = g.Ip
    gu = _gradient_tensor(u, setup, box)
    G = jnp.stack([jnp.stack(row, -1) for row in gu], -2)  # (*box, 3, 3)
    S = (G + jnp.swapaxes(G, -1, -2)) / 2
    R = (G - jnp.swapaxes(G, -1, -2)) / 2
    M = S @ S + R @ R
    out = jnp.zeros(g.N, u.dtype)
    return out.at[slc(box)].set(_eigvals2_sym3(M))


def get_scale_numbers(u, setup):
    """Dimensional turbulence scale numbers (src/operators.jl:1569-1619).

    Returns dict with uavg, eps (dissipation), eta, lambda, Re_lambda,
    L (integral scale), tau, Re_int. Requires uniform periodic grid for L.
    """
    g = setup.grid
    D = g.dim
    visc = 1 / setup.Re
    dtype = setup.dtype

    # Velocity rms over u-volumes
    uavg_sq = 0.0
    for a in range(D):
        full = tuple((0, n) for n in g.N)
        om = 1.0
        for b in range(D):
            om = om * seg(g.delta_u[b] if a == b else g.delta[b], full, b)
        box = g.Iu[0]
        field = u[a] ** 2 * om
        uavg_sq = uavg_sq + jnp.sum(field[slc(box)]) / jnp.sum(
            (om * jnp.ones(g.N, dtype))[slc(box)]
        )
    uavg = jnp.sqrt(uavg_sq)

    om = scalewithvolume(jnp.ones(g.N, dtype), setup)
    epsf = dissipation_from_strain(u, setup)
    ipslc = slc(g.Ip)
    eps_ = jnp.sum((om * epsf)[ipslc]) / jnp.sum(om[ipslc])
    eta = (visc**3 / eps_) ** 0.25
    lam = jnp.sqrt(5 * visc / eps_) * uavg
    re_lam = lam * uavg / np.sqrt(3.0) / visc

    # Integral length scale via spectrum (uniform periodic only)
    K = tuple(n // 2 for n in g.Np)
    up = jnp.stack([u[a][ipslc] for a in range(D)])
    uhat = jnp.fft.fftn(up, axes=tuple(range(1, D + 1)))
    uhat = uhat[(slice(None),) + tuple(slice(0, k) for k in K)]
    e = jnp.abs(uhat) ** 2 / (2 * float(np.prod(g.Np)) ** 2)
    kk = sum(
        np.reshape(
            np.arange(K[d], dtype=np.float64) ** 2,
            tuple(K[d] if i == d else 1 for i in range(D)),
        )
        for d in range(D)
    )
    inv_knorm = 1.0 / np.sqrt(np.where(kk == 0, 1.0, kk))
    inv_knorm[(0,) * D] = 0.0  # origin mode folded in (no runtime scatter)
    e = jnp.sum(e, axis=0) * jnp.asarray(inv_knorm, dtype)
    L = 3 * np.pi / 2 / uavg_sq * jnp.sum(e)
    tau = L / uavg
    re_int = L * uavg / visc
    return dict(
        uavg=uavg,
        eps=eps_,
        eta=eta,
        lam=lam,
        Re_lam=re_lam,
        L=L,
        tau=tau,
        Re_int=re_int,
    )
