"""Energy-spectrum binning utilities.

Re-design of IncompressibleNavierStokes.jl `src/utils.jl:49-143`: dyadic
binning in 2D (k^-3 inertial slope), linear binning in 3D (k^-5/3). Bins
are precomputed as a dense (npoint, nk) boolean matrix so the in-loop
spectrum reduction is one masked matmul instead of the
reference's per-bin index gathers.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["spectral_stuff", "splitseed", "get_lims", "getoffset"]


def getoffset(box):
    """Starting offsets of an index box (reference `getoffset`,
    src/utils.jl:19-22: the offset of a `CartesianIndices`; here index
    boxes are tuples of `(start, end)` per dimension)."""
    return tuple(int(s) for s, _ in box)


def splitseed(seed, n):
    """Split an integer seed into `n` seeds (reference src/utils.jl:25)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32 - 1, size=n, dtype=np.uint32)


def get_lims(x, n=1.5):
    """Approximate field limits mu +- n sigma (reference src/utils.jl:32-38)."""
    x = np.asarray(x)
    mu, sigma = float(np.mean(x)), float(np.std(x))
    eps = float(np.finfo(x.dtype).eps)
    if abs(sigma) <= math.sqrt(eps) * (abs(mu) + 1):
        sigma = math.sqrt(math.sqrt(eps))
    return (mu - n * sigma, mu + n * sigma)


def spectral_stuff(setup, *, npoint=100, a=(1 + math.sqrt(5)) / 2):
    """Precompute spectrum bins.

    Returns dict with:
    - `kappa`: integer query wavenumbers (log-spaced),
    - `K`: per-dim wavenumber counts,
    - 2D: `masks`, (npoint, *K) boolean bin masks (dyadic bins overlap, so
      the reduction is a masked matmul);
    - 3D: `bin_id`, a (*K,) int32 map cell -> bin (len(kappa) = "no bin"),
      reduced with one `segment_sum` — the 3D linear bins are disjoint, and
      the dense-mask matmul would need O(npoint * prod(K)) memory (~840 MB
      at 256^3, unusable at 512^3). Mirrors the reference's precomputed
      index lists (src/utils.jl:49-108).
    """
    g = setup.grid
    D = g.dim
    K = tuple(n // 2 for n in g.Np)

    kk = np.zeros(K)
    for d in range(D):
        kd = np.arange(K[d]).reshape(
            tuple(-1 if i == d else 1 for i in range(D))
        )
        kk = kk + kd.astype(np.float64) ** 2
    k = np.sqrt(kk)

    kmax = min(K) - 1
    kappa = np.unique(
        np.round(
            np.exp(np.linspace(np.log(1.0), np.log(kmax), npoint))
        ).astype(int)
    )

    out = dict(kappa=jnp.asarray(kappa), K=K)
    if D == 2:
        # Dyadic binning (k^-3 slope in 2D); bins overlap, keep masks
        masks = [(k >= kap / a) & (k < kap * a) for kap in kappa]
        out["masks"] = jnp.asarray(np.stack(masks))
    else:
        # Linear binning (k^-5/3 slope in 3D): cell -> bin of the integer
        # shell floor(k + tol); shells absent from kappa map to the
        # overflow id len(kappa) and are dropped by the segment_sum.
        tol = 0.01
        shell = np.floor(k + tol).astype(np.int64)
        lut = np.full(int(shell.max()) + 2, len(kappa), dtype=np.int32)
        lut[kappa] = np.arange(len(kappa), dtype=np.int32)
        out["bin_id"] = jnp.asarray(lut[shell])
    return out


def observe_spectrum(u_hat_energy, st):
    """Bin a spectral energy field using precomputed `spectral_stuff`
    bins: masked matmul (2D, overlapping dyadic bins) or one segment_sum
    over the flat bin-id map (3D, disjoint linear bins)."""
    e = u_hat_energy.reshape(-1)
    if "bin_id" in st:
        nk = st["kappa"].shape[0]
        return jax.ops.segment_sum(
            e, st["bin_id"].reshape(-1), num_segments=nk + 1
        )[:nk]
    m = st["masks"].reshape(st["masks"].shape[0], -1).astype(e.dtype)
    return m @ e
