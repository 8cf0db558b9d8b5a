"""The quad bilinear sampler kernels (``csrc/quad_sample.cu``,
``csrc/quad_sample_bwd.cu``, ``csrc/quad_sample_reduce.cu``) and their glue.

Counterpart of ``hgsfusion_tpu/ops/pallas_sample.py``. Its forward kernels
``_gather_combine`` (rows layout) and ``_gather_combine_planes`` (planes
layout) compute one function and become the one CUDA kernel
``quad_sample_fwd``; its backward kernels ``_scatter_outer`` and
``_scatter_outer_planes`` (with ``_unshift``) become ``quad_sample_bwd``.
The forward takes the sampling coordinates in place and the unpadded map,
computes every query's top-left tap and four weights itself, bit for bit as
``quad_indices`` computes them (as ``_indices`` does outside the TPU
kernels: the weights in the feature dtype, then carried in f32), reads a tap
only where its weight is not 0, sums the four in f32 and rounds once. When
the map needs a gradient, the same launch writes ``quad_indices``' result
for the backward, and the glue bins the queries by their top-left pixel
(``quad_bins``, PyTorch's sort and search on the card); the backward kernel
sums each output tile from those bins in shared memory, rounds once and
writes the cropped gradient.

Where no gradient is taken, the gather view fuses the sampler with its
reduce product: ``quad_sample_reduce_fwd`` computes the taps the same way,
gathers and combines them from each gather group's unpadded map and
multiplies them by the group's rows of the reduce kernel in one launch, into
one output in the compute dtype (the function of the TPU prototype
``_bench_gather_pallas.py::pallas_gather_combine_matmul``).
``library.quad_sample_taps`` runs that kernel's tap computation alone, so it can be
held against ``quad_indices`` bit for bit.

F2V QUANT int8 (the JAX package's ``grid_sample_2d_quad_q8``) samples the
map's per-channel int8 quantization and leaves the scales to the caller:
``quad_sample_fwd`` on an int8 map is K1's int8 instantiation (the
training route, with a straight-through gradient through K2),
``quad_sample_reduce_q8_fwd`` the fused kernel on int8 maps with the
scales folded into the reduce rows (the no-gradient route).

A CPU tensor takes the plain versions (``quad_sample_fwd_uv_plain``,
``ops/grid_sample.py``); a CUDA tensor launches the kernels or raises. The
coordinates get no gradient: the grid is calibration geometry, as in the JAX
package's ``_bwd``. The kernels' launch wrappers and launch counts, and the
``torch.library`` ops that the no-gradient routes call, live in
``ops/library.py``; this module holds the glue and the plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .grid_sample import (quad_sample_bwd_plain, quad_sample_fwd_plain, quad_taps,
                          quantize_per_channel_int8)
from . import library
from .library import (quad_sample_bwd, quad_sample_fwd, quad_sample_op, quad_sample_reduce_op,
                      quad_sample_reduce_q8_op)
from .matmul import matmul_f32


def quad_indices(features, coords, dtype=None):
    """Per-query (flat top-left pixel index into the padded map, int32;
    tap weights (N, 4), f32, or f64 for f64 features) for ``features``
    (B, H, W, C), ``coords`` (B, ..., 2); the weights rounded to ``dtype``
    (default: the features')."""
    b, h, w, _ = features.shape
    if b * (h + 2) * (w + 2) >= 2**31:
        raise ValueError("padded map exceeds int32 pixel indexing")
    coords = coords.reshape(b, -1, 2)
    yp, xp, w4 = quad_taps(coords, h, w, features.dtype if dtype is None else dtype)
    base = torch.arange(b, device=coords.device)[:, None] * ((h + 2) * (w + 2))
    idx = (base + yp * (w + 2) + xp).reshape(-1)
    w4 = torch.stack(w4, dim=-1).reshape(-1, 4)
    return idx.to(torch.int32), w4.to(torch.promote_types(w4.dtype, torch.float32))


def quad_sample_fwd_uv_plain(features, uv, taps: bool = False):
    """Plain version of ``quad_sample_fwd``, same arguments and result:
    ``quad_indices``, the zero-padded map and ``quad_sample_fwd_plain`` (the
    taps combined in the feature dtype)."""
    idx, w4 = quad_indices(features, uv)
    out = quad_sample_fwd_plain(F.pad(features, (0, 0, 1, 1, 1, 1)), idx, w4)
    return (out, idx, w4) if taps else (out, None, None)


def quad_sample_reduce_plain(uv, groups, kmat, bias):
    """Plain version of ``quad_sample_reduce_fwd``, same arguments: each
    group sampled by ``quad_sample_fwd_uv_plain`` (the taps combined in the
    compute dtype), multiplied by its rows of ``kmat`` with ``matmul_f32``
    and added onto the bias in f32, rounded once -> (N, O) in the compute
    dtype."""
    n = uv.numel() // 2
    out = bias.to(torch.float32).expand(n, kmat.shape[1]).clone()
    for f, k_off in groups:
        out.add_(matmul_f32(quad_sample_fwd_uv_plain(f, uv)[0],
                            kmat[k_off:k_off + f.shape[-1]]))
    return out.to(kmat.dtype)


def quad_sample_reduce(uv, groups, kmat, bias):
    """The fused sampler + reduce on any device: the op
    ``hgsfusion::quad_sample_reduce_fwd``, which launches
    ``quad_sample_reduce_fwd`` on CUDA tensors and takes
    ``quad_sample_reduce_plain`` on CPU tensors; same arguments."""
    return quad_sample_reduce_op(uv, [f for f, _ in groups], [int(k) for _, k in groups],
                                 kmat, bias)


def quad_sample_q8_plain(q, uv, dtype, taps: bool = False):
    """Plain version of ``library.quad_sample_fwd`` on an int8 map ``q``
    (``quad_sample_fwd(q, uv, taps, dtype=dtype)``), same result:
    ``quad_indices`` with the weights in ``dtype``, the int8 map's values
    combined in f32 (exact integers) and rounded once to ``dtype``."""
    idx, w4 = quad_indices(q, uv, dtype)
    out = quad_sample_fwd_plain(F.pad(q.to(torch.float32), (0, 0, 1, 1, 1, 1)), idx, w4)
    return (out.to(dtype), idx, w4) if taps else (out.to(dtype), None, None)


def quad_sample_reduce_q8_plain(uv, groups, kmat, bias):
    """Plain version of ``library.quad_sample_reduce_q8_fwd``, same
    arguments: each int8 group sampled by ``quad_sample_q8_plain`` in the
    compute dtype, multiplied by its (scaled) rows of ``kmat`` with
    ``matmul_f32`` and added onto the bias in f32, rounded once."""
    n = uv.numel() // 2
    out = bias.to(torch.float32).expand(n, kmat.shape[1]).clone()
    for q, k_off in groups:
        out.add_(matmul_f32(quad_sample_q8_plain(q, uv, kmat.dtype)[0],
                            kmat[k_off:k_off + q.shape[-1]]))
    return out.to(kmat.dtype)


def quad_sample_reduce_q8(uv, groups, kmat, bias):
    """The int8 fused sampler + reduce on any device: the op
    ``hgsfusion::quad_sample_reduce_q8_fwd`` (``quad_sample_reduce_q8_plain``
    on CPU tensors); same arguments."""
    return quad_sample_reduce_q8_op(uv, [q for q, _ in groups], [int(k) for _, k in groups],
                                    kmat, bias)


def quad_bins(idx, w4, padded_shape):
    """The backward kernel's bins: the queries with any nonzero weight,
    grouped by their top-left pixel.

    Returns ``order`` (N,) int32, the queries sorted by ``idx``, stable in
    query order, those whose four weights are all 0 last (under the key
    B*(H+2)*(W+2), past every pixel); and ``start`` (B*(H+2)*(W+2) + 1,)
    int32, each pixel's run in ``order`` (``start[-1]`` counts the queries
    with a nonzero weight). No step reads back to the host.
    """
    b, hp2, wp2, _ = padded_shape
    pixels = b * hp2 * wp2
    # any of a query's four weights nonzero: its four flags read as one int32
    valid = (w4 != 0).view(torch.int32).squeeze(1) != 0
    bins = csr_bins(torch.where(valid, idx, pixels), pixels)
    if idx.is_cuda:
        library.launches[library.BINS] += 1
    return bins


def csr_bins(key, n: int):
    """``order`` (N,) int32, the positions of ``key`` (N,) sorted by key,
    stable; ``start`` (n + 1,) int32, the run of each key 0 .. n - 1 in
    ``order``, so a key of ``n`` (past every bin) sorts last and
    ``start[n]`` counts the others. No step reads back to the host."""
    lo = 0
    if n < 2**16:  # 16-bit keys, shifted to keep their order: half the radix passes
        lo = -2**15
        key = (key + lo).to(torch.int16)
    keys, order = torch.sort(key, stable=True)
    start = torch.searchsorted(
        keys, torch.arange(lo, lo + n + 1, dtype=keys.dtype, device=keys.device),
        out_int32=True)
    return order.to(torch.int32), start


class _QuadSample(torch.autograd.Function):
    """The training route: the forward with idx/w4 and the bins, then the
    backward kernel, on CUDA tensors; plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, features, coords):
        b, h, w, c = features.shape
        ctx.padded_shape = (b, h + 2, w + 2, c)
        ctx.dtype = features.dtype
        # one launch on the card: coords read in place, the map as it is
        # (the model's maps are contiguous, so .contiguous() copies nothing)
        features = features.contiguous()
        fwd = quad_sample_fwd if features.is_cuda else quad_sample_fwd_uv_plain
        out, idx, w4 = fwd(features, coords, taps=True)
        bins = quad_bins(idx, w4, ctx.padded_shape) if features.is_cuda else ()
        ctx.save_for_backward(idx, w4, *bins)
        return out.view(coords.shape[:-1] + (c,))

    @staticmethod
    def backward(ctx, grad_out):
        idx, w4, *bins = ctx.saved_tensors
        g = grad_out.to(ctx.dtype).reshape(idx.shape[0], -1)
        if g.is_cuda:
            return quad_sample_bwd(g.contiguous(), idx, w4, ctx.padded_shape, bins), None
        return quad_sample_bwd_plain(g, idx, w4, ctx.padded_shape), None


class _QuadSampleQ8(torch.autograd.Function):
    """F2V QUANT int8's sample (the JAX package's ``grid_sample_2d_quad_q8``):
    forward, the per-channel quantization and the sample of the int8 map
    (K1 on it with idx/w4 and the bins, on CUDA tensors); backward
    straight-through, the exact sampler's gradient (K2) of the map in the
    compute dtype for the cotangent divided by the scales in its own dtype,
    as JAX's ``ct_out / scale.astype(ct_out.dtype)``. The scales get no
    gradient."""

    @staticmethod
    def forward(ctx, features, coords, dtype):
        b, h, w, c = features.shape
        ctx.padded_shape = (b, h + 2, w + 2, c)
        ctx.dtype, ctx.features_dtype = dtype, features.dtype
        q, scale = quantize_per_channel_int8(features)
        if q.is_cuda:
            out, idx, w4 = quad_sample_fwd(q, coords, taps=True, dtype=dtype)
        else:
            out, idx, w4 = quad_sample_q8_plain(q, coords, dtype, taps=True)
        bins = quad_bins(idx, w4, ctx.padded_shape) if q.is_cuda else ()
        ctx.save_for_backward(idx, w4, scale, *bins)
        ctx.mark_non_differentiable(scale)
        return out.view(coords.shape[:-1] + (c,)), scale

    @staticmethod
    def backward(ctx, grad_out, _grad_scale):
        idx, w4, scale, *bins = ctx.saved_tensors
        ct = grad_out.to(ctx.dtype)
        g = (ct / scale.to(ct.dtype)).reshape(idx.shape[0], -1)
        if g.is_cuda:
            gf = quad_sample_bwd(g.contiguous(), idx, w4, ctx.padded_shape, bins)
        else:
            gf = quad_sample_bwd_plain(g, idx, w4, ctx.padded_shape)
        return gf.to(ctx.features_dtype), None, None


def grid_sample_2d_quad_q8_kernel(features, coords, dtype):
    """F2V QUANT int8's sample through the kernels: features (B, H, W, C)
    of any float dtype, coords (B, ..., 2) normalized -> (the unscaled
    samples coords.shape[:-1] + (C,) in ``dtype``, the per-channel scales
    (C,) f32), as the JAX package's ``grid_sample_2d_quad_q8(features,
    coords, dtype)``; differentiable in ``features`` (straight-through). CPU
    tensors take the plain versions."""
    if features.device.type not in ("cpu", "cuda") or coords.device != features.device:
        raise ValueError(f"grid_sample_2d_quad_q8_kernel: features on "
                         f"{features.device}, coords on {coords.device}")
    return _QuadSampleQ8.apply(features, coords, dtype)


def grid_sample_2d_quad_kernel(features, coords):
    """Bilinear sample (align_corners=True, zeros padding) through the kernels.

    Same contract as the JAX package's ``grid_sample_2d_quad_pallas``:
    features (B, H, W, C), coords (B, ..., 2) normalized; returns
    coords.shape[:-1] + (C,), any C; differentiable in ``features``. CPU
    tensors take the plain versions. Where no gradient is taken the call is
    the op ``hgsfusion::quad_sample_fwd`` itself, so ``torch.export`` traces
    it as one node.
    """
    if features.device.type not in ("cpu", "cuda") or coords.device != features.device:
        raise ValueError(f"grid_sample_2d_quad_kernel: features on "
                         f"{features.device}, coords on {coords.device}")
    if torch.is_grad_enabled() and features.requires_grad:
        return _QuadSample.apply(features, coords)
    return quad_sample_op(features.contiguous(), coords).view(
        coords.shape[:-1] + (features.shape[-1],))
