"""Fourier neural operator closure (reference lib/NeuralClosure/src/fno.jl).

Each FourierLayer combines a pointwise (1x1) spatial path with a spectral
path: FFT -> keep modes |k| <= kmax (low and high bands, 2(kmax+1) per dim)
-> per-mode complex channel mixing -> zero-pad -> IFFT. NHWC layout.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from .closure import collocate, create_closure, decollocate

__all__ = ["fno", "FNO", "FourierLayer"]


class FourierLayer(nn.Module):
    kmax: int
    cout: int
    activation: object = lambda x: x
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):
        # x: (b, *nx, cin), all nx equal, kmax <= nx/2 - 1
        D = x.ndim - 2
        cin = x.shape[-1]
        K = x.shape[1]
        assert all(s == K for s in x.shape[1:-1]), "FNO needs a cubic grid"
        nk = 2 * (self.kmax + 1)
        assert nk <= K, "kmax too large for grid"

        W = self.param(
            "spatial_weight",
            nn.initializers.glorot_uniform(),
            (cin, self.cout),
            self.dtype,
        )
        R = self.param(
            "spectral_weights",
            nn.initializers.glorot_uniform(in_axis=-2, out_axis=-3),
            (*([nk] * D), self.cout, cin, 2),
            self.dtype,
        )

        # Spatial (pointwise) path
        y = jnp.einsum("...a,ab->...b", x, W)

        # Spectral path: keep the 2(kmax+1) lowest |k| modes per dim
        # (reference fno.jl:142-194)
        keep = np.concatenate(
            [np.arange(self.kmax + 1), np.arange(K - self.kmax - 1, K)]
        )
        xhat = jnp.fft.fftn(x, axes=tuple(range(1, D + 1)))
        for d in range(D):
            xhat = jnp.take(xhat, keep, axis=1 + d)
        Rc = R[..., 0] + 1j * R[..., 1]
        z = jnp.einsum("...ba,n...a->n...b", Rc, xhat)
        # Zero-pad back to K modes per dim
        for d in range(D):
            axis = 1 + d
            lo = jax.lax.slice_in_dim(z, 0, self.kmax + 1, axis=axis)
            hi = jax.lax.slice_in_dim(z, self.kmax + 1, nk, axis=axis)
            pad_shape = list(lo.shape)
            pad_shape[axis] = K - nk
            z = jnp.concatenate(
                [lo, jnp.zeros(pad_shape, z.dtype), hi], axis=axis
            )
        z = jnp.real(jnp.fft.ifftn(z, axes=tuple(range(1, D + 1)))).astype(x.dtype)

        return self.activation(y + z)


class FNO(nn.Module):
    kmax: tuple
    channels: tuple
    activations: tuple
    psi: object  # activation of the first compression layer
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):
        D = x.ndim - 2
        x = collocate(x)
        for i in range(len(self.kmax)):
            x = FourierLayer(
                kmax=self.kmax[i],
                cout=self.channels[i],
                activation=self.activations[i],
                dtype=self.dtype,
            )(x)
        c = self.channels[-1]
        x = nn.Conv(2 * c, (1,) * D, dtype=self.dtype, param_dtype=self.dtype)(x)
        x = self.psi(x)
        x = nn.Conv(
            D, (1,) * D, use_bias=False, dtype=self.dtype, param_dtype=self.dtype
        )(x)
        return decollocate(x)


def fno(*, setup, kmax, c, sigma, psi, rng):
    """Build `(closure, theta)` (reference fno.jl:5-45)."""
    g = setup.grid
    D = g.dim
    n = tuple(e - s for (s, e) in g.Iu[0])
    assert all(m == n[0] for m in n)
    model = FNO(
        kmax=tuple(kmax),
        channels=tuple(c),
        activations=tuple(sigma),
        psi=psi,
        dtype=setup.dtype,
    )
    return create_closure(
        model, rng=rng, sample_shape=(*n, D), dtype=setup.dtype
    )
