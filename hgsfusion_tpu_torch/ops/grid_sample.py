"""Bilinear grid sampling (align_corners=True, zeros padding), NHWC layout.

Counterpart of ``hgsfusion_tpu/ops/grid_sample.py``: the quad-packed
single-gather sampler, its shared index/weight computation and the int8
payload's per-channel quantization (F2V QUANT int8). These make
the plain PyTorch versions of the ``quad_sample_fwd`` and ``quad_sample_bwd``
CUDA kernels (``ops/quad_sample.py``: ``quad_sample_fwd_uv_plain``,
``quad_sample_bwd_plain``); the CPU path and the tests use them, and they are
the references the kernels are held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(coord, size: int):
    """align_corners=True: [-1, 1] -> [0, size-1]."""
    return (coord + 1.0) * 0.5 * (size - 1)


def quad_taps(coords, h: int, w: int, dtype):
    """Top-left tap of each query on the zero-padded map + its 4 tap weights.

    coords (..., 2) normalized (x indexes W, y indexes H). Returns (yp, xp)
    int64 indices into the (H+2, W+2) padded map, clamped so the 2x2 patch is
    always inside it, and the weights (w00, w01, w10, w11) in ``dtype`` with
    the zeros-padding masks folded in (computed in the feature dtype, as the
    reference does, so the bf16 path rounds the same way).
    """
    ix = _unnormalize(coords[..., 0], w)
    iy = _unnormalize(coords[..., 1], h)
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    tx = (ix - ix0).to(dtype)
    ty = (iy - iy0).to(dtype)

    def inb(v, n):
        return ((v >= 0) & (v <= n - 1)).to(dtype)

    mx0, mx1 = inb(ix0, w), inb(ix0 + 1, w)
    my0, my1 = inb(iy0, h), inb(iy0 + 1, h)
    xp = torch.clamp(ix0 + 1, 0, w).long()
    yp = torch.clamp(iy0 + 1, 0, h).long()
    w4 = (
        (1 - tx) * (1 - ty) * mx0 * my0,
        tx * (1 - ty) * mx1 * my0,
        (1 - tx) * ty * mx0 * my1,
        tx * ty * mx1 * my1,
    )
    return yp, xp, w4


def div_exact(a, divisor: float):
    """``a / divisor``, correctly rounded on any device: a Python number as
    divisor makes PyTorch's CUDA division multiply by its reciprocal, which
    can miss the quotient by one ulp."""
    return a / torch.full((), divisor, dtype=a.dtype, device=a.device)


def quantize_per_channel_int8(features):
    """Symmetric per-channel int8 quantization of a (B, H, W, C) map, bit
    for bit the JAX package's: (q int8 (B, H, W, C), scale f32 (C,)) with
    scale = max(max|f|, 1e-12) / 127 over (B, H, W) and q = round(f / scale)
    (half to even) clipped to [-127, 127], all in f32."""
    f32 = features.to(torch.float32)
    amax = f32.abs().amax(dim=(0, 1, 2))
    scale = div_exact(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(f32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _quad_idx_weights(coords, h: int, w: int, dtype):
    """Flat quad-row index yp*(W+1) + xp + the 4 tap weights (as the JAX
    package's ``_quad_idx_weights``)."""
    yp, xp, w4 = quad_taps(coords, h, w, dtype)
    return yp * (w + 1) + xp, w4


def grid_sample_2d_quad(features, coords):
    """Bilinear sample with zero padding, one gather per query.

    features (B, H, W, C); coords (B, ..., 2) in [-1, 1]. Returns
    coords.shape[:-1] + (C,). Builds the 2x2-patch table (4C channels) over
    the zero-padded map and combines the four taps in the feature dtype.
    """
    b, h, w, c = features.shape
    out_shape = coords.shape[:-1] + (c,)
    coords = coords.reshape(b, -1, 2)
    hp, wp = h + 1, w + 1
    fp = F.pad(features, (0, 0, 1, 1, 1, 1))
    quad = torch.cat(
        [fp[:, :-1, :-1], fp[:, :-1, 1:], fp[:, 1:, :-1], fp[:, 1:, 1:]],
        dim=-1,
    ).reshape(b, hp * wp, 4 * c)
    flat, (w00, w01, w10, w11) = _quad_idx_weights(coords, h, w, features.dtype)
    rows = torch.gather(quad, 1, flat[..., None].expand(-1, -1, 4 * c))
    out = (
        rows[..., 0 * c:1 * c] * w00[..., None]
        + rows[..., 1 * c:2 * c] * w01[..., None]
        + rows[..., 2 * c:3 * c] * w10[..., None]
        + rows[..., 3 * c:4 * c] * w11[..., None]
    )
    return out.reshape(out_shape)


def quad_sample_fwd_plain(fp, idx, w4):
    """The reads and combine of ``quad_sample_fwd``'s plain version
    (``ops/quad_sample.py::quad_sample_fwd_uv_plain``).

    fp (B, H+2, W+2, C) zero-padded map, idx (N,) flat top-left pixel of each
    query in it, w4 (N, 4) tap weights (feature-dtype values carried in a
    wider type) -> (N, C): the four taps combined in the feature dtype, in
    the order and rounding of ``grid_sample_2d_quad``.
    """
    wp2, c = fp.shape[2], fp.shape[3]
    flat = fp.reshape(-1, c)
    i = idx.long()
    w = w4.to(fp.dtype)
    return (flat[i] * w[:, 0:1] + flat[i + 1] * w[:, 1:2]
            + flat[i + wp2] * w[:, 2:3] + flat[i + wp2 + 1] * w[:, 3:4])


def quad_sample_bwd_plain(grad_out, idx, w4, padded_shape):
    """Plain version of the ``quad_sample_bwd`` kernel.

    grad_out (N, C) cotangent of the sampled rows, idx (N,) flat top-left
    pixel of each query in the padded map, w4 (N, 4) tap weights,
    padded_shape (B, H+2, W+2, C). Adds w4[j, tap] * grad_out[j] at the four
    tap pixels with ``index_add_`` in f32 (f64 for f64 input), then crops the
    ring and casts once to grad_out's dtype -> (B, H, W, C).
    """
    b, hp2, wp2, c = padded_shape
    acc_dtype = torch.promote_types(grad_out.dtype, torch.float32)
    acc = torch.zeros((b * hp2 * wp2, c), dtype=acc_dtype, device=grad_out.device)
    g = grad_out.reshape(-1, c).to(acc_dtype)
    i = idx.long()
    for tap, off in enumerate((0, 1, wp2, wp2 + 1)):
        acc.index_add_(0, i + off, g * w4[:, tap:tap + 1].to(acc_dtype))
    return acc.view(b, hp2, wp2, c)[:, 1:-1, 1:-1].to(grad_out.dtype)
