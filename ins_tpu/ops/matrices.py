"""Sparse-matrix mirrors of the matrix-free operators.

Re-design of IncompressibleNavierStokes.jl `src/matrices.jl` on
scipy.sparse (host-side; used for setup-time factorizations in
`psolver_direct` and for implicit-diffusion solves — these never run in the
device hot loop). Flattening convention: scalar fields ravel row-major over
`N`; vector fields ravel row-major over `(D, *N)` (component-major), i.e.
`u.ravel()` of this framework's component-first layout.

Validated against the matrix-free twins in tests/test_matrices.py
(mirroring reference test/matrices.jl).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..boundary_conditions import (
    DirichletBC,
    PeriodicBC,
    PressureBC,
    SymmetricBC,
    boundary_plane,
    box_slices,
)

__all__ = [
    "pad_scalarfield_mat",
    "pad_vectorfield_mat",
    "bc_u_mat",
    "bc_p_mat",
    "bc_temp_mat",
    "divergence_mat",
    "pressuregradient_mat",
    "volume_mat",
    "laplacian_mat",
    "diffusion_mat",
]


def _np_dtype(setup):
    return np.dtype(setup.dtype)


def _ilin_p(g):
    return np.arange(int(np.prod(g.N))).reshape(g.N)


def _ilin_u(g):
    n = int(np.prod(g.N)) * g.dim
    return np.arange(n).reshape((g.dim, *g.N))


def _flat(ilin, box, comp=None, shift=None):
    sl = box_slices(box, shift)
    if comp is None:
        return ilin[sl].ravel()
    return ilin[(comp,) + sl].ravel()


def pad_scalarfield_mat(setup):
    """Pad inner pressure DOFs with ghost volumes (src/matrices.jl:23-32).
    Transpose restricts back to DOFs."""
    g = setup.grid
    n = int(np.prod(g.N))
    npp = int(np.prod(g.Np))
    ii = _flat(_ilin_p(g), g.Ip)
    jj = np.arange(npp)
    return sp.csr_matrix(
        (np.ones(npp, _np_dtype(setup)), (ii, jj)), shape=(n, npp)
    )


def pad_vectorfield_mat(setup):
    """Pad inner velocity DOFs with ghost volumes (src/matrices.jl:38-52)."""
    g = setup.grid
    D = g.dim
    n = int(np.prod(g.N)) * D
    ilin = _ilin_u(g)
    ii = np.concatenate([_flat(ilin, g.Iu[a], comp=a) for a in range(D)])
    nu = len(ii)
    jj = np.arange(nu)
    return sp.csr_matrix(
        (np.ones(nu, _np_dtype(setup)), (ii, jj)), shape=(n, nu)
    )


# --------------------------------------------------------------------------
# Boundary-condition matrices (homogeneous part only: constant Dirichlet
# data is not part of the matrix, cf. src/matrices.jl:54-57)
# --------------------------------------------------------------------------


def _identity_except_plane(ilin, N, beta, plane_idx, comp=None):
    """(i, j) identity pairs over all indices except the plane
    `dim beta == plane_idx`."""
    D = len(N)
    keep = np.ones(N[beta], bool)
    keep[plane_idx] = False
    idx = np.nonzero(keep)[0]
    sl = tuple(idx if d == beta else slice(None) for d in range(D))
    if comp is None:
        ii = ilin[sl].ravel()
    else:
        ii = ilin[(comp,) + sl].ravel()
    return ii, ii.copy()


def _bc_u_mat_side(bc, setup, beta, isright):
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N)) * D
    ilin = _ilin_u(g)
    dtype = _np_dtype(setup)
    if isinstance(bc, PeriodicBC):
        if isright:
            return sp.identity(n, dtype=dtype, format="csr")
        i_, j_ = [], []
        # Identity away from both boundary planes of dim beta
        for a in range(D):
            keep = np.ones(N[beta], bool)
            keep[0] = keep[N[beta] - 1] = False
            idx = np.nonzero(keep)[0]
            sl = tuple(idx if d == beta else slice(None) for d in range(D))
            ii = ilin[(a,) + sl].ravel()
            i_.append(ii)
            j_.append(ii)
        Ia = boundary_plane(beta, N, g.Ip, False)
        Ib = boundary_plane(beta, N, g.Ip, True)
        for a in range(D):
            i_.append(_flat(ilin, Ia, comp=a))
            j_.append(_flat(ilin, Ib, comp=a, shift={beta: -1}))
            i_.append(_flat(ilin, Ib, comp=a))
            j_.append(_flat(ilin, Ia, comp=a, shift={beta: +1}))
        ii = np.concatenate(i_)
        jj = np.concatenate(j_)
        return sp.csr_matrix(
            (np.ones(len(ii), dtype), (ii, jj)), shape=(n, n)
        )
    i_, j_ = [], []
    for a in range(D):
        s, e = g.Iu[a][beta]
        plane = e if isright else s - 1
        ii, jj = _identity_except_plane(ilin, N, beta, plane, comp=a)
        i_.append(ii)
        j_.append(jj)
        if isinstance(bc, SymmetricBC) and a != beta:
            box = boundary_plane(beta, N, g.Iu[a], isright)
            i_.append(_flat(ilin, box, comp=a))
            j_.append(_flat(ilin, box, comp=a, shift={beta: -1 if isright else 1}))
        if isinstance(bc, PressureBC):
            box = boundary_plane(beta, N, g.Iu[a], isright)
            i_.append(_flat(ilin, box, comp=a))
            j_.append(_flat(ilin, box, comp=a, shift={beta: -1 if isright else 1}))
    ii = np.concatenate(i_)
    jj = np.concatenate(j_)
    return sp.csr_matrix((np.ones(len(ii), dtype), (ii, jj)), shape=(n, n))


def _bc_p_mat_side(bc, setup, beta, isright):
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N))
    ilin = _ilin_p(g)
    dtype = _np_dtype(setup)
    if isinstance(bc, PeriodicBC):
        if isright:
            return sp.identity(n, dtype=dtype, format="csr")
        keep = np.ones(N[beta], bool)
        keep[0] = keep[N[beta] - 1] = False
        idx = np.nonzero(keep)[0]
        sl = tuple(idx if d == beta else slice(None) for d in range(D))
        ii = ilin[sl].ravel()
        i_, j_ = [ii], [ii.copy()]
        Ia = boundary_plane(beta, N, g.Ip, False)
        Ib = boundary_plane(beta, N, g.Ip, True)
        i_.append(_flat(ilin, Ia))
        j_.append(_flat(ilin, Ib, shift={beta: -1}))
        i_.append(_flat(ilin, Ib))
        j_.append(_flat(ilin, Ia, shift={beta: +1}))
        ii = np.concatenate(i_)
        jj = np.concatenate(j_)
        return sp.csr_matrix(
            (np.ones(len(ii), dtype), (ii, jj)), shape=(n, n)
        )
    if isinstance(bc, DirichletBC):
        return sp.identity(n, dtype=dtype, format="csr")  # not used for p
    s, e = g.Ip[beta]
    plane = e if isright else s - 1
    ii, jj = _identity_except_plane(ilin, N, beta, plane)
    i_, j_ = [ii], [jj]
    if isinstance(bc, SymmetricBC):
        box = boundary_plane(beta, N, g.Ip, isright)
        i_.append(_flat(ilin, box))
        j_.append(_flat(ilin, box, shift={beta: -1 if isright else 1}))
    # PressureBC: plane stays zero (p = 0)
    ii = np.concatenate(i_)
    jj = np.concatenate(j_)
    return sp.csr_matrix((np.ones(len(ii), dtype), (ii, jj)), shape=(n, n))


def _bc_temp_mat_side(bc, setup, beta, isright):
    g = setup.grid
    N = g.N
    n = int(np.prod(N))
    dtype = _np_dtype(setup)
    if isinstance(bc, PeriodicBC):
        return _bc_p_mat_side(bc, setup, beta, isright)
    if isinstance(bc, DirichletBC):
        s, e = g.Ip[beta]
        plane = e if isright else s - 1
        ii, jj = _identity_except_plane(_ilin_p(g), N, beta, plane)
        return sp.csr_matrix(
            (np.ones(len(ii), dtype), (ii, jj)), shape=(n, n)
        )
    if isinstance(bc, (SymmetricBC, PressureBC)):
        # PressureBC temp fill is symmetric (apply_bc_temp), so the matrix
        # matches the actual kernel (the reference maps it to bc_p_mat).
        return _bc_p_mat_side(SymmetricBC(), setup, beta, isright)
    raise TypeError(f"Unknown boundary condition {bc!r}")


def _compose(side_fn, setup, bcs_getter):
    B = None
    for beta in range(setup.grid.dim):
        bcl, bcr = bcs_getter(beta)
        a = side_fn(bcl, setup, beta, False)
        b = side_fn(bcr, setup, beta, True)
        Bd = b @ a
        B = Bd if B is None else Bd @ B
    return B.tocsr()


def bc_u_mat(setup):
    """Velocity BC application as a matrix (src/matrices.jl:67-78)."""
    return _compose(
        _bc_u_mat_side, setup, lambda b: setup.boundary_conditions[b]
    )


def bc_p_mat(setup):
    """Pressure BC application as a matrix (src/matrices.jl:80-91)."""
    return _compose(
        _bc_p_mat_side, setup, lambda b: setup.boundary_conditions[b]
    )


def bc_temp_mat(setup):
    """Temperature BC application as a matrix (src/matrices.jl:93-104)."""
    return _compose(
        _bc_temp_mat_side,
        setup,
        lambda b: setup.temperature.boundary_conditions[b],
    )


# --------------------------------------------------------------------------
# Operator matrices
# --------------------------------------------------------------------------


def divergence_mat(setup):
    """Divergence matrix (src/matrices.jl:389-427)."""
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N))
    ilp = _ilin_p(g)
    ilu = _ilin_u(g)
    dtype = _np_dtype(setup)
    delta = [np.asarray(d) for d in g.delta]
    i_, j_, v_ = [], [], []
    box = g.Ip
    shape = tuple(e - s for (s, e) in box)
    for a in range(D):
        s, e = box[a]
        dI = delta[a][s:e].reshape(
            tuple(-1 if d == a else 1 for d in range(D))
        )
        dI = np.broadcast_to(dI, shape).ravel()
        ip = _flat(ilp, box)
        i_ += [ip, ip]
        j_ += [_flat(ilu, box, comp=a), _flat(ilu, box, comp=a, shift={a: -1})]
        v_ += [1.0 / dI, -1.0 / dI]
    return sp.csr_matrix(
        (
            np.concatenate(v_).astype(dtype),
            (np.concatenate(i_), np.concatenate(j_)),
        ),
        shape=(n, n * D),
    )


def pressuregradient_mat(setup):
    """Pressure-gradient matrix (src/matrices.jl:430-468)."""
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N))
    ilp = _ilin_p(g)
    ilu = _ilin_u(g)
    dtype = _np_dtype(setup)
    delta_u = [np.asarray(d) for d in g.delta_u]
    i_, j_, v_ = [], [], []
    for a in range(D):
        box = g.Iu[a]
        shape = tuple(e - s for (s, e) in box)
        s, e = box[a]
        dI = delta_u[a][s:e].reshape(
            tuple(-1 if d == a else 1 for d in range(D))
        )
        dI = np.broadcast_to(dI, shape).ravel()
        iu = _flat(ilu, box, comp=a)
        i_ += [iu, iu]
        j_ += [_flat(ilp, box, shift={a: +1}), _flat(ilp, box)]
        v_ += [1.0 / dI, -1.0 / dI]
    return sp.csr_matrix(
        (
            np.concatenate(v_).astype(dtype),
            (np.concatenate(i_), np.concatenate(j_)),
        ),
        shape=(n * D, n),
    )


def volume_mat(setup):
    """Diagonal volume-size matrix (src/matrices.jl:471-478)."""
    g = setup.grid
    n = int(np.prod(g.N))
    om = np.ones(g.N, _np_dtype(setup))
    for d in range(g.dim):
        om = om * np.asarray(g.delta[d]).reshape(
            tuple(-1 if i == d else 1 for i in range(g.dim))
        )
    return sp.diags(om.ravel()).tocsr()


def laplacian_mat(setup):
    """Laplacian composition P' Ω M B_u G B_p P (src/matrices.jl:484-492):
    the pressure-Poisson operator restricted to pressure DOFs."""
    P = pad_scalarfield_mat(setup)
    Bp = bc_p_mat(setup)
    Bu = bc_u_mat(setup)
    G = pressuregradient_mat(setup)
    M = divergence_mat(setup)
    Om = volume_mat(setup)
    return (P.T @ (Om @ (M @ (Bu @ (G @ (Bp @ P)))))).tocsr()


def diffusion_mat(setup):
    """Diffusion matrix, `use_viscosity=false` form with the same eps-guard
    as the kernel (src/matrices.jl:495-555)."""
    g = setup.grid
    D, N = g.dim, g.N
    n = int(np.prod(N)) * D
    ilu = _ilin_u(g)
    dtype = _np_dtype(setup)
    eps2 = 2 * np.finfo(dtype).eps
    delta = [np.asarray(d) for d in g.delta]
    delta_u = [np.asarray(d) for d in g.delta_u]
    i_, j_, v_ = [], [], []
    for a in range(D):
        box = g.Iu[a]
        shape = tuple(e - s for (s, e) in box)

        def seg_np(arr, d, shift=0):
            s, e = box[d]
            return np.broadcast_to(
                arr[s + shift : e + shift].reshape(
                    tuple(-1 if i == d else 1 for i in range(D))
                ),
                shape,
            ).ravel()

        for b in range(D):
            duab = seg_np(delta_u[b] if a == b else delta[b], b)
            da = seg_np(delta[b], b) if b == a else seg_np(delta_u[b], b, -1)
            db = seg_np(delta[b], b, 1) if b == a else seg_np(delta_u[b], b)
            av = np.where(da > eps2, 1.0 / da / duab, 0.0)
            bv = np.where(db > eps2, 1.0 / db / duab, 0.0)
            iu = _flat(ilu, box, comp=a)
            i_ += [iu, iu, iu]
            j_ += [
                _flat(ilu, box, comp=a, shift={b: -1}),
                _flat(ilu, box, comp=a, shift={b: +1}),
                iu,
            ]
            v_ += [av, bv, -(av + bv)]
    return sp.csr_matrix(
        (
            np.concatenate(v_).astype(dtype),
            (np.concatenate(i_), np.concatenate(j_)),
        ),
        shape=(n, n),
    )
