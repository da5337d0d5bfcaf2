"""CNN closure model (reference lib/NeuralClosure/src/cnn.jl).

Circular-padded convolution stack on collocated velocities, output
differentiated back to staggered faces.

Implementation notes (design choices; their speed on the GPU is not
measured yet):

1. **Tap folding.** Kernel taps are folded into the input-channel dim
   (x, then y, then z) until the folded channel count reaches 64: for a
   fold of the x-tap dim, ``g[..., (dx, ci)] = h_pad[x + dx, ..., ci]``
   (kx shifted copies concatenated on channels) turns the (5,5,5)xCin
   conv into a (1,5,5)x(5 Cin) conv with identical FLOPs but a wider
   contraction for the small closure channel counts (3..24).  Weight
   tensors keep their canonical (kx,ky,kz,Cin,Cout) parameter shape;
   the fold is a trace-time transpose+reshape.

2. **bf16 taps.** By default the folded copies are stored and multiplied
   in bf16 with f32 accumulation (`compute_dtype`), which halves the
   memory footprint of the fold concat.  An f32 `compute_dtype` runs the
   convolutions at `Precision.HIGHEST` (no TF32).

3. **x-chunking** (memory, large grids): the fold copies and their
   backward-pass cotangents grow with the grid, so inputs with
   ``nx >= chunk_min_nx`` are evaluated in x-CHUNKS: the field is
   circularly halo-padded by the stack's total receptive radius once,
   and `lax.map` runs the conv stack slab by slab (VALID in x), which
   bounds the temporaries to one chunk's worth in both the forward and
   the backward pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import flax.linen as nn

from .closure import collocate, create_closure, decollocate

__all__ = ["cnn", "CNN"]

_DN = {
    1: ("NWC", "WIO", "NWC"),
    2: ("NHWC", "HWIO", "NHWC"),
    3: ("NDHWC", "DHWIO", "NDHWC"),
}

# Fold kernel-tap dims into input channels until the folded channel
# count reaches this (contraction width; see module docstring).
_FOLD_TARGET = 64


def _fold_count(cin, k, D):
    f, c = 0, cin
    while c < _FOLD_TARGET and f < D:
        c *= k
        f += 1
    return f


def _fold_conv(h, w, r, pad_axes, compute_dtype):
    """One conv layer via the tap-folding formulation.

    `h`: (N, *spatial, cin); `w`: ((2r+1),)*D + (cin, cout) canonical
    weights.  `pad_axes[d]` selects wrap-padding by r on spatial dim d;
    where False the halo is assumed supplied by the caller (chunked
    path) and the conv is VALID.  Output is f32-accumulated in the
    input's dtype.
    """
    D = h.ndim - 2
    k = 2 * r + 1
    cin, cout = w.shape[-2], w.shape[-1]
    f = _fold_count(cin, k, D) if r > 0 else 0
    pads = (
        [(0, 0)]
        + [((r, r) if pad_axes[d] else (0, 0)) for d in range(D)]
        + [(0, 0)]
    )
    g = jnp.pad(h, pads, mode="wrap") if (r > 0 and any(pad_axes)) else h
    g = g.astype(compute_dtype)
    wf = w.astype(compute_dtype)  # (*taps, C, cout)
    for ax in range(f):
        ext = g.shape[1 + ax] - 2 * r
        g = jnp.concatenate(
            [jax.lax.slice_in_dim(g, d, d + ext, axis=1 + ax)
             for d in range(k)],
            axis=-1,
        )
        # channels are now (d_ax major, C minor): move this tap dim of
        # the weight next to C and merge, matching the concat order.
        wf = jnp.moveaxis(wf, 0, -3)
        wf = wf.reshape(*wf.shape[:-3], wf.shape[-3] * wf.shape[-2], cout)
    kernel = wf.reshape((1,) * f + wf.shape)
    # Same-dtype conv (bf16 inputs still accumulate in f32); a mixed
    # preferred_element_type breaks the conv transpose rule.  f32 and
    # f64 convs run at HIGHEST: TF32 would keep ~3 decimal digits.
    prec = (
        jax.lax.Precision.DEFAULT
        if jnp.dtype(compute_dtype).itemsize < 4
        else jax.lax.Precision.HIGHEST
    )
    out = jax.lax.conv_general_dilated(
        g, kernel, (1,) * D, "VALID", dimension_numbers=_DN[D],
        precision=prec,
    )
    return out.astype(h.dtype)


class CNN(nn.Module):
    radii: tuple
    channels: tuple  # output channels per layer; last must equal D
    activations: tuple  # callables, one per layer
    use_bias: tuple
    dtype: object = jnp.float32
    chunk_x: int = 16  # x-chunk size for large 3D inputs
    chunk_min_nx: int = 128  # chunk only at/above this x extent
    # conv compute dtype; None = bf16 when dtype is f32 (docstring
    # note 2)
    compute_dtype: object = None

    @nn.compact
    def __call__(self, x):
        D = x.ndim - 2
        assert self.channels[-1] == D, "Output must have D force channels"
        in_dtype = x.dtype
        x = collocate(x).astype(self.dtype)  # (N, *spatial, D)
        kinit = jax.nn.initializers.lecun_normal()
        ws, bs = [], []
        cin = D
        for i, r in enumerate(self.radii):
            cout = self.channels[i]
            ws.append(self.param(
                f"conv{i}_kernel", kinit,
                (2 * r + 1,) * D + (cin, cout), self.dtype,
            ))
            bs.append(
                self.param(f"conv{i}_bias", jax.nn.initializers.zeros,
                           (cout,), self.dtype)
                if self.use_bias[i]
                else None
            )
            cin = cout

        cdt = self.compute_dtype
        if cdt is None:
            cdt = jnp.bfloat16 if self.dtype == jnp.float32 else self.dtype

        def stack(h, pad_x):
            for i, r in enumerate(self.radii):
                pad_axes = (pad_x,) + (True,) * (D - 1)
                h = _fold_conv(h, ws[i], r, pad_axes, cdt)
                if bs[i] is not None:
                    h = h + bs[i]
                h = self.activations[i](h)
            return h

        R = sum(self.radii)
        nx = x.shape[1]
        cx = self.chunk_x
        if D == 3 and nx >= self.chunk_min_nx and nx % cx == 0:
            # x-chunked evaluation (see module docstring)
            xp = jnp.pad(
                x, [(0, 0), (R, R)] + [(0, 0)] * D, mode="wrap"
            )
            idx = jnp.arange(nx // cx) * cx

            def body(i0):
                sl = jax.lax.dynamic_slice_in_dim(xp, i0, cx + 2 * R, 1)
                return stack(sl, pad_x=False)

            out = jax.lax.map(body, idx)  # (nchunk, N, cx, ny, nz, D)
            out = jnp.moveaxis(out, 0, 1).reshape(
                x.shape[0], nx, *x.shape[2:-1], D
            )
        else:
            out = stack(x, pad_x=True)
        return decollocate(out.astype(in_dtype))


def cnn(*, setup, radii, channels, activations, use_bias, rng,
        compute_dtype=None):
    """Build `(closure, theta)` (reference cnn.jl:5-48).
    ``compute_dtype``: conv multiply dtype — None (default) uses bf16
    with f32 accumulation for f32 models; pass ``jnp.float32`` for f32
    convs at `Precision.HIGHEST` (e.g. cross-device gradient parity
    checks)."""
    g = setup.grid
    D = g.dim
    n = tuple(e - s for (s, e) in g.Iu[0])
    model = CNN(
        radii=tuple(radii),
        channels=tuple(channels),
        activations=tuple(activations),
        use_bias=tuple(use_bias),
        dtype=setup.dtype,
        compute_dtype=compute_dtype,
    )
    return create_closure(
        model, rng=rng, sample_shape=(*n, D), dtype=setup.dtype
    )
