"""The depth-weighted frustum sampler of the gather view under USE_DEPTH
(``csrc/quad_sample_depth.cu``) and its glue.

Counterpart of ``hgsfusion_tpu/models/frustum.py::FrustumToVoxelMultiScale.
_sample_with_depth``, which XLA computes in the JAX package: the trilinear
sample (``align_corners=True``, zeros padding) of the frustum volume
probs[d, h, w] * feat[c, h, w] at each (u, v, z) of the grid, factorized so
the (B, C, D, H, W) volume is never built: per bilinear tap, the depth lerp
of the tap's two bins around z, times the tap's weight, times its features.

The kernel ``quad_sample_depth_fwd`` computes the taps from the grid read in
place, reads two bins of each tap with a weight and sums the products in f32,
rounded once. Under a gradient the same launch writes each query's effective
tap weights (weight x depth lerp) and the key its bins sort by
(``depth_bins``), so the features' gradient is the plain sampler's backward
kernel ``quad_sample_bwd`` on those weights, unchanged, and the
probabilities' gradient is ``quad_sample_depth_bwd``, which walks the same
bins. A CPU tensor takes the plain versions here; a CUDA tensor launches the
kernels or raises. The grid gets no gradient (calibration geometry). The
launch wrappers, their counts and the op ``hgsfusion::quad_sample_depth_fwd``
live in ``ops/library.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import library
from .grid_sample import quad_sample_bwd_plain
from .library import quad_sample_bwd, quad_sample_depth_bwd, quad_sample_depth_fwd
from .quad_sample import csr_bins, quad_indices


def depth_lerp(z, depth_bins: int, dtype):
    """Per query (d0 (N,) int64, a0, a1 (N,) f32): the lower bin of the
    normalized depth coordinate ``z`` and the weights of bins d0 and d0 + 1,
    0 where a bin is outside 0 .. D - 1, as ``_sample_with_depth`` computes
    them (td and 1 - td in ``dtype``). d0 is clamped to -1 .. D."""
    dc = (z.reshape(-1) + 1.0) * 0.5 * (depth_bins - 1)
    f0 = torch.floor(dc)
    td = (dc - f0).to(dtype)
    in0 = (f0 >= 0) & (f0 <= depth_bins - 1)
    in1 = (f0 + 1 >= 0) & (f0 + 1 <= depth_bins - 1)
    a0 = torch.where(in0, (1 - td).float(), torch.zeros((), device=z.device))
    a1 = torch.where(in1, td.float(), torch.zeros((), device=z.device))
    d0 = torch.clamp(torch.nan_to_num(f0, nan=-1.0), -1, depth_bins).long()
    return d0, a0, a1


def _taps(features, grid, d: int):
    """idx (N,) into the padded map, the raw tap weights (N, 4) f32, the
    depth lerp over ``d`` bins and the padded map's tap offsets."""
    w = features.shape[2]
    idx, w4 = quad_indices(features, grid[..., 0:2])
    d0, a0, a1 = depth_lerp(grid[..., 2], d, features.dtype)
    offs = (0, 1, w + 2, w + 3)
    return idx.long(), w4.float(), (d0, a0, a1), offs


def quad_sample_depth_fwd_plain(features, probs, grid, taps: bool = False):
    """Plain version of ``quad_sample_depth_fwd``, same arguments and
    result: ``quad_indices`` and ``depth_lerp``, the two bins of each tap
    read from the zero-padded probabilities, the effective weights
    w_t (a0 p[d0] + a1 p[d0 + 1]) and the four taps summed in f32, rounded
    once to features' dtype."""
    b, h, w, c = features.shape
    d = probs.shape[-1]
    idx, w4, (d0, a0, a1), offs = _taps(features, grid, d)
    fp = F.pad(features, (0, 0, 1, 1, 1, 1)).reshape(-1, c).float()
    pp = F.pad(probs, (0, 0, 1, 1, 1, 1)).reshape(-1, d).float()
    lo, hi = d0.clamp(0, d - 1), (d0 + 1).clamp(0, d - 1)
    out = torch.zeros((idx.shape[0], c), dtype=torch.float32, device=features.device)
    we = []
    for t, off in enumerate(offs):
        pix = idx + off
        pd = a0 * pp[pix, lo] + a1 * pp[pix, hi]
        we.append(w4[:, t] * pd)
        out += we[-1][:, None] * fp[pix]
    valid = (w4 != 0).any(dim=1) & ((a0 != 0) | (a1 != 0))
    key = torch.where(valid, idx, b * (h + 2) * (w + 2)).to(torch.int32)
    out = out.to(features.dtype)
    return (out, key, torch.stack(we, dim=1)) if taps else (out, None, None)


def quad_sample_depth_bwd_plain(grad_out, features, grid, depth_bins: int):
    """Plain version of ``quad_sample_depth_bwd`` (without the bins): for
    every query and tap s_t = w_t <grad_out, feat_t> in f32, added by
    ``index_add_`` to bins d0 (times a0) and d0 + 1 (times a1) of the tap's
    pixel -> (B, H, W, D) f32."""
    b, h, w, c = features.shape
    d = depth_bins
    idx, w4, (d0, a0, a1), offs = _taps(features, grid, d)
    fp = F.pad(features, (0, 0, 1, 1, 1, 1)).reshape(-1, c).float()
    g = grad_out.reshape(-1, c).float()
    acc = torch.zeros(b * (h + 2) * (w + 2) * d, dtype=torch.float32, device=features.device)
    lo, hi = d0.clamp(0, d - 1), (d0 + 1).clamp(0, d - 1)
    for t, off in enumerate(offs):
        pix = idx + off
        s = w4[:, t] * (g * fp[pix]).sum(dim=1)
        acc.index_add_(0, pix * d + lo, s * a0)
        acc.index_add_(0, pix * d + hi, s * a1)
    return acc.view(b, h + 2, w + 2, d)[:, 1:-1, 1:-1].contiguous()


def depth_bins(key, padded_shape):
    """The bins both backward kernels walk: ``csr_bins`` of the forward's
    keys (each query's top-left pixel in the padded map, or B (H+2) (W+2)
    for a query that reaches no bin, sorted last)."""
    b, hp2, wp2, _ = padded_shape
    bins = csr_bins(key, b * hp2 * wp2)
    if key.is_cuda:
        library.launches[library.BINS] += 1
    return bins


class _QuadSampleDepth(torch.autograd.Function):
    """The training route: the forward with the effective weights and keys,
    the bins, then ``quad_sample_bwd`` for the features and
    ``quad_sample_depth_bwd`` for the probabilities on CUDA tensors; plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, features, probs, grid):
        b, h, w, c = features.shape
        ctx.padded_shape = (b, h + 2, w + 2, c)
        ctx.depth_bins = probs.shape[-1]
        ctx.probs_dtype = probs.dtype
        features, probs = features.contiguous(), probs.contiguous()
        fwd = quad_sample_depth_fwd if features.is_cuda else quad_sample_depth_fwd_plain
        out, key, we = fwd(features, probs, grid, taps=True)
        bins = depth_bins(key, ctx.padded_shape) if features.is_cuda else ()
        ctx.save_for_backward(features, grid, key, we, *bins)
        return out.view(grid.shape[:-1] + (c,))

    @staticmethod
    def backward(ctx, grad_out):
        features, grid, key, we, *bins = ctx.saved_tensors
        g = grad_out.to(features.dtype).reshape(key.shape[0], -1).contiguous()
        d_feat = d_probs = None
        if g.is_cuda:
            if ctx.needs_input_grad[0]:
                d_feat = quad_sample_bwd(g, key, we, ctx.padded_shape, bins)
            if ctx.needs_input_grad[1]:
                d_probs = quad_sample_depth_bwd(g, features, grid, ctx.depth_bins, bins)
        else:
            if ctx.needs_input_grad[0]:
                # a query that reaches no bin has effective weights 0: its
                # sentinel key only needs to index inside the map
                b, hp2, wp2, _ = ctx.padded_shape
                idx = torch.where(key < b * hp2 * wp2, key, 0)
                d_feat = quad_sample_bwd_plain(g, idx, we, ctx.padded_shape)
            if ctx.needs_input_grad[1]:
                d_probs = quad_sample_depth_bwd_plain(g, features, grid, ctx.depth_bins)
        if d_probs is not None:
            d_probs = d_probs.to(ctx.probs_dtype)
        return d_feat, d_probs, None


def grid_sample_depth_kernel(features, probs, grid):
    """The depth-weighted frustum sample through the kernels.

    features (B, H, W, C) and probs (B, H, W, D) in one dtype (the compute
    dtype), grid (B, ..., 3) normalized (u, v, z) -> grid.shape[:-1] + (C,)
    in that dtype; differentiable in features and probs. CPU tensors take
    the plain versions. Where no gradient is taken the call is the op
    ``hgsfusion::quad_sample_depth_fwd`` itself, one node for
    ``torch.export``.
    """
    if features.device.type not in ("cpu", "cuda") or grid.device != features.device \
            or probs.device != features.device:
        raise ValueError(f"grid_sample_depth_kernel: features on {features.device}, probs on "
                         f"{probs.device}, grid on {grid.device}")
    if torch.is_grad_enabled() and (features.requires_grad or probs.requires_grad):
        return _QuadSampleDepth.apply(features, probs, grid)
    return library.quad_sample_depth_op(features.contiguous(), probs.contiguous(), grid).view(
        grid.shape[:-1] + (features.shape[-1],))
