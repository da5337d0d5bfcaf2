"""Periodic spectral pressure solve (`jnp.fft` real transforms with the
`spectral_inverse_laplacian` multiplier): checked against a float64
dense solve of the volume-scaled periodic Laplacian, in 2-D and 3-D,
for odd and even extents and anisotropic spacings."""

import jax.numpy as jnp
import numpy as np
import pytest

import ins_tpu as ins
from ins_tpu.ops.pressure import spectral_inverse_laplacian

CASES = [
    ((8, 8), (0.1, 0.1)),
    ((9, 12), (0.2, 0.15)),
    ((7, 7), (0.3, 0.3)),
    ((6, 10), (0.05, 0.4)),
    ((11, 5), (1.0, 0.7)),
    ((6, 6, 6), (0.1, 0.1, 0.1)),
    ((5, 6, 7), (0.2, 0.15, 0.1)),
    ((4, 5, 8), (0.3, 0.05, 0.2)),
    ((7, 7, 4), (0.5, 0.5, 0.25)),
    ((3, 8, 6), (1.0, 0.2, 0.6)),
]
IDS = ["x".join(map(str, n)) + "_" + "_".join(map(str, d)) for n, d in CASES]


def _dense_laplacian(Np, dxs):
    """Volume-scaled periodic Laplacian sum_d vol/dx_d^2 (1, -2, 1)_d."""
    vol = float(np.prod(dxs))
    L = 0.0
    for d, n in enumerate(Np):
        T = -2.0 * np.eye(n) + np.roll(np.eye(n), 1, 0) + np.roll(np.eye(n), -1, 0)
        mats = [np.eye(m) for m in Np]
        mats[d] = T * vol / dxs[d] ** 2
        K = mats[0]
        for M in mats[1:]:
            K = np.kron(K, M)
        L = L + K
    return L


def _dense_solve(f, Np, dxs):
    """Zero-mean least-squares solution of L p = f (L is singular)."""
    L = _dense_laplacian(Np, dxs)
    p = np.linalg.lstsq(L, f.ravel(), rcond=None)[0]
    return (p - p.mean()).reshape(Np)


def _setup(Np, dxs):
    x = tuple(np.linspace(0.0, n * dx, n + 1) for n, dx in zip(Np, dxs))
    bc = ((ins.PeriodicBC(), ins.PeriodicBC()),) * len(Np)
    return ins.Setup(x=x, boundary_conditions=bc, Re=100.0, dtype=jnp.float64)


@pytest.mark.parametrize("Np,dxs", CASES, ids=IDS)
def test_spectral_multiplier_matches_dense(Np, dxs):
    rng = np.random.default_rng(sum(Np))
    f = rng.standard_normal(Np)
    f -= f.mean()
    inv = jnp.asarray(spectral_inverse_laplacian(Np, dxs))
    p = np.asarray(jnp.fft.irfftn(jnp.fft.rfftn(jnp.asarray(f)) * inv, Np))
    ref = _dense_solve(f, Np, dxs)
    assert abs(p.mean()) < 1e-12  # zero-mean gauge
    assert np.linalg.norm(p - ref) / np.linalg.norm(ref) < 1e-11


@pytest.mark.parametrize("Np,dxs", CASES, ids=IDS)
def test_psolver_spectral_projection_matches_dense(Np, dxs):
    """`ins.project` with `psolver_spectral` (ghosted layout) == the dense
    projection u - G L^-1 (vol * div u), and leaves u divergence-free."""
    setup = _setup(Np, dxs)
    D = len(Np)
    ps = ins.psolver_spectral(setup)
    rng = np.random.default_rng(7 + sum(Np))
    ui = rng.standard_normal((D,) + tuple(Np))
    u = jnp.pad(jnp.asarray(ui), ((0, 0),) + ((1, 1),) * D, mode="wrap")
    up = np.asarray(ins.project(u, setup, psolver=ps))
    inner = (slice(None),) + (slice(1, -1),) * D

    vol = float(np.prod(dxs))
    div = sum((ui[a] - np.roll(ui[a], 1, a)) / dxs[a] for a in range(D)) * vol
    p = _dense_solve(div, Np, dxs)
    ref = np.stack(
        [ui[a] - (np.roll(p, -1, a) - p) / dxs[a] for a in range(D)]
    )
    assert np.max(np.abs(up[inner] - ref)) < 1e-10 * np.max(np.abs(ref))
    un = up[inner]
    dnew = sum((un[a] - np.roll(un[a], 1, a)) / dxs[a] for a in range(D))
    assert np.max(np.abs(dnew)) < 1e-10 * np.max(np.abs(ui)) / min(dxs)
