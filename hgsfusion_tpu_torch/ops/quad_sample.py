"""The quad bilinear sampler kernels (``csrc/quad_sample.cu``,
``csrc/quad_sample_bwd.cu``, ``csrc/quad_sample_reduce.cu``) and their glue.

Counterpart of ``hgsfusion_tpu/ops/pallas_sample.py``. Its forward kernels
``_gather_combine`` (rows layout) and ``_gather_combine_planes`` (planes
layout) compute one function and become the one CUDA kernel
``quad_sample_fwd``; its backward kernels ``_scatter_outer`` and
``_scatter_outer_planes`` (with ``_unshift``) become ``quad_sample_bwd``. The
glue computes the top-left tap index and the four tap weights of every query
in PyTorch, as ``_indices`` does outside the TPU kernels: the weights in the
feature dtype, then carried in f32. The forward reads the four taps straight
from the zero-padded map, sums them in f32 and rounds once. When the map
needs a gradient, the forward also bins the queries by their top-left pixel
(``quad_bins``, PyTorch's sort and search on the card); the backward kernel
sums each output tile from those bins in shared memory, rounds once and
writes the cropped gradient.

Where no gradient is taken, the gather view fuses the sampler with its
reduce product: ``quad_sample_reduce_fwd`` gathers and combines the taps of
every gather group and multiplies them by the group's rows of the reduce
kernel in one launch, into one f32 output (the function of the TPU
prototype ``_bench_gather_pallas.py::pallas_gather_combine_matmul``).

A CPU tensor takes the plain versions (``ops/grid_sample.py``); a CUDA tensor
launches the kernels or raises. The coordinates get no gradient: the grid is
calibration geometry, as in the JAX package's ``_bwd``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import native
from ..models.layers import matmul_f32
from .grid_sample import quad_sample_bwd_plain, quad_sample_fwd_plain, quad_taps

KERNEL = "quad_sample_fwd"
REDUCE_KERNEL = "quad_sample_reduce_fwd"
BWD_KERNEL = "quad_sample_bwd"
BINS = "quad_bins"
# launches of each kernel in this process, and the bins built on the card
# for the backward kernel (PyTorch calls, no kernel of this package);
# callers may reset them to 0
launches = {KERNEL: 0, REDUCE_KERNEL: 0, BWD_KERNEL: 0, BINS: 0}
# gather groups one launch of the fused kernel takes
MAX_REDUCE_GROUPS = 4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PP, _PI, _PI64 = (ctypes.POINTER(t) for t in (_P, _I, _I64))
# each kernel's source in csrc/ and C arguments
_ENTRIES = {
    # fp, idx, w4, out, n, c, row_pixels, dtype, stream
    KERNEL: ("quad_sample", [_P, _P, _P, _P, _I64, _I, _I64, _I, _P]),
    # fps, idxs, w4s, row_pixels, cs, k_offs (one entry per group), groups,
    # kmat, bias, out, n, o, dtype, stream
    REDUCE_KERNEL: ("quad_sample_reduce",
                    [_PP, _PP, _PP, _PI64, _PI, _PI, _I, _P, _P, _P, _I64, _I, _I, _P]),
    # ct, order, start, w4, out, b, h, w, c, dtype, stream
    BWD_KERNEL: ("quad_sample_bwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
}


@functools.cache
def _entry(name: str):
    source, argtypes = _ENTRIES[name]
    fn = getattr(native.load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def quad_indices(features, coords):
    """Per-query (flat top-left pixel index into the padded map, int32;
    tap weights (N, 4), f32, or f64 for f64 features) for ``features``
    (B, H, W, C), ``coords`` (B, ..., 2)."""
    b, h, w, _ = features.shape
    if b * (h + 2) * (w + 2) >= 2**31:
        raise ValueError("padded map exceeds int32 pixel indexing")
    coords = coords.reshape(b, -1, 2)
    yp, xp, w4 = quad_taps(coords, h, w, features.dtype)
    base = torch.arange(b, device=coords.device)[:, None] * ((h + 2) * (w + 2))
    idx = (base + yp * (w + 2) + xp).reshape(-1)
    w4 = torch.stack(w4, dim=-1).reshape(-1, 4)
    return idx.to(torch.int32), w4.to(torch.promote_types(w4.dtype, torch.float32))


def _check(name, data, idx, w4):
    """The launch contract both kernels share; ``data`` is the tensor whose
    dtype the kernel reads (the map, or the cotangent)."""
    if data.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {data.device}")
    if data.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {data.dtype}")
    if idx.dim() != 1 or w4.shape != (idx.shape[0], 4):
        raise ValueError(f"{name}: bad shapes idx {tuple(idx.shape)} w4 {tuple(w4.shape)}")
    if idx.dtype != torch.int32 or w4.dtype != torch.float32:
        raise TypeError(f"{name}: idx must be int32 and w4 float32")
    for arg, t in (("data", data), ("idx", idx), ("w4", w4)):
        if t.device != data.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {data.device}")
    if data.data_ptr() % 16 or w4.data_ptr() % 16:
        raise ValueError(f"{name}: {data.dtype} data and w4 must be 16-byte aligned")


def quad_sample_fwd(fp, idx, w4):
    """Launch the forward kernel: ``fp`` (B, H+2, W+2, C) zero-padded map,
    ``idx`` (N,) int32, ``w4`` (N, 4) f32 -> (N, C) in ``fp``'s dtype."""
    _check(KERNEL, fp, idx, w4)
    if fp.dim() != 4:
        raise ValueError(f"{KERNEL}: bad shapes fp {tuple(fp.shape)}")
    n, c = idx.shape[0], fp.shape[-1]
    out = torch.empty((n, c), dtype=fp.dtype, device=fp.device)
    err = _entry(KERNEL)(
        fp.data_ptr(), idx.data_ptr(), w4.data_ptr(), out.data_ptr(), n, c,
        fp.shape[2], _DTYPE_CODES[fp.dtype], torch.cuda.current_stream(fp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    launches[KERNEL] += 1
    return out


def _check_reduce(groups, kmat, bias):
    """The fused kernel's launch contract beyond ``_check``'s; returns (n, o)."""
    name = REDUCE_KERNEL
    if not 1 <= len(groups) <= MAX_REDUCE_GROUPS:
        raise ValueError(f"{name}: {len(groups)} groups, takes 1 to {MAX_REDUCE_GROUPS}")
    if kmat.dim() != 2 or bias.shape != (kmat.shape[1],):
        raise ValueError(f"{name}: bad shapes kmat {tuple(kmat.shape)} bias {tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name}: bias must be float32, got {bias.dtype}")
    n = groups[0][1].shape[0]
    for fp, idx, w4, k_off in groups:
        _check(name, fp, idx, w4)
        if fp.dtype != kmat.dtype:
            raise TypeError(f"{name}: map {fp.dtype} and kmat {kmat.dtype} differ")
        if fp.dim() != 4 or idx.shape[0] != n or not 0 <= k_off <= kmat.shape[0] - fp.shape[-1]:
            raise ValueError(f"{name}: bad shapes fp {tuple(fp.shape)} idx {tuple(idx.shape)} "
                             f"at kmat rows {k_off} of {tuple(kmat.shape)}")
    for arg, t in (("kmat", kmat), ("bias", bias)):
        if t.device != groups[0][0].device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned on "
                             f"{groups[0][0].device}")
    return n, kmat.shape[1]


def quad_sample_reduce_fwd(groups, kmat, bias):
    """Launch the fused kernel: for each of the ``groups`` (fp, idx, w4,
    k_off), its zero-padded map ``fp`` (B, H+2, W+2, c) in the compute
    dtype, ``idx`` (N,) int32 and ``w4`` (N, 4) f32 as ``quad_indices``
    builds them, and its first row ``k_off`` of ``kmat`` (sum c, O) in the
    compute dtype; ``bias`` (O,) f32 -> (N, O) f32, the bias plus each
    group's sampled rows (four taps summed in f32, rounded once to the
    compute dtype) times its rows of ``kmat``, every product summed in f32.
    Same function as ``quad_sample_reduce_plain`` up to the taps' rounding
    and the order of the f32 sums."""
    n, o = _check_reduce(groups, kmat, bias)
    out = torch.empty((n, o), dtype=torch.float32, device=kmat.device)
    g = len(groups)
    fps = (_P * g)(*(fp.data_ptr() for fp, _, _, _ in groups))
    idxs = (_P * g)(*(idx.data_ptr() for _, idx, _, _ in groups))
    w4s = (_P * g)(*(w4.data_ptr() for _, _, w4, _ in groups))
    rows = (_I64 * g)(*(fp.shape[2] for fp, _, _, _ in groups))
    cs = (_I * g)(*(fp.shape[3] for fp, _, _, _ in groups))
    offs = (_I * g)(*(k_off for _, _, _, k_off in groups))
    err = _entry(REDUCE_KERNEL)(
        fps, idxs, w4s, rows, cs, offs, g, kmat.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, o, _DTYPE_CODES[kmat.dtype], torch.cuda.current_stream(kmat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{REDUCE_KERNEL} launch failed: cudaError {err}")
    launches[REDUCE_KERNEL] += 1
    return out


def quad_sample_reduce_plain(groups, kmat, bias):
    """Plain version of ``quad_sample_reduce_fwd``, same arguments: each
    group sampled by ``quad_sample_fwd_plain`` (the taps combined in the
    compute dtype), multiplied by its rows of ``kmat`` with ``matmul_f32``
    and added onto the bias in f32 -> (N, O) f32."""
    out = bias.to(torch.float32).expand(groups[0][1].shape[0], kmat.shape[1]).clone()
    for fp, idx, w4, k_off in groups:
        c = fp.shape[-1]
        out.add_(matmul_f32(quad_sample_fwd_plain(fp, idx, w4), kmat[k_off:k_off + c]))
    return out


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
        launches[BINS] += 1
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


def quad_sample_bwd(grad_out, idx, w4, padded_shape, bins):
    """Launch the backward kernel: ``grad_out`` (N, C) cotangent of the
    sampled rows, ``idx`` (N,) int32, ``w4`` (N, 4) f32, ``padded_shape``
    (B, H+2, W+2, C), ``bins`` = ``quad_bins(idx, w4, padded_shape)`` -> the
    map's gradient (B, H, W, C) in grad_out's dtype. Same contract as
    ``quad_sample_bwd_plain``."""
    _check(BWD_KERNEL, grad_out, idx, w4)
    b, hp2, wp2, c = padded_shape
    n = idx.shape[0]
    if grad_out.shape != (n, c):
        raise ValueError(f"{BWD_KERNEL}: bad shapes grad_out {tuple(grad_out.shape)} "
                         f"for the padded map {tuple(padded_shape)}")
    if 4 * n >= 2**31:
        raise ValueError(f"{BWD_KERNEL}: {n} queries exceed int32 tile lists")
    order, start = bins
    for arg, t, length in (("order", order, n), ("start", start, b * hp2 * wp2 + 1)):
        if t.dtype != torch.int32:
            raise TypeError(f"{BWD_KERNEL}: bins {arg} must be int32, got {t.dtype}")
        if t.device != grad_out.device or not t.is_contiguous():
            raise ValueError(f"{BWD_KERNEL}: bins {arg} must be contiguous on {grad_out.device}")
        if t.shape != (length,):
            raise ValueError(f"{BWD_KERNEL}: bad shapes bins {arg} {tuple(t.shape)}, "
                             f"want ({length},)")
    out = torch.empty((b, hp2 - 2, wp2 - 2, c), dtype=grad_out.dtype, device=grad_out.device)
    err = _entry(BWD_KERNEL)(
        grad_out.data_ptr(), order.data_ptr(), start.data_ptr(), w4.data_ptr(), out.data_ptr(),
        b, hp2 - 2, wp2 - 2, c, _DTYPE_CODES[grad_out.dtype],
        torch.cuda.current_stream(grad_out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: cudaError {err}")
    launches[BWD_KERNEL] += 1
    return out


class _QuadSample(torch.autograd.Function):
    """Kernels on CUDA tensors, plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, features, coords):
        b, h, w, c = features.shape
        ctx.padded_shape = (b, h + 2, w + 2, c)
        ctx.dtype = features.dtype
        idx, w4 = quad_indices(features, coords)
        fp = F.pad(features, (0, 0, 1, 1, 1, 1)).contiguous()
        fwd = quad_sample_fwd if features.is_cuda else quad_sample_fwd_plain
        out = fwd(fp, idx, w4).reshape(coords.shape[:-1] + (c,))
        if ctx.needs_input_grad[0]:
            bins = quad_bins(idx, w4, ctx.padded_shape) if features.is_cuda else ()
            ctx.save_for_backward(idx, w4, *bins)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        idx, w4, *bins = ctx.saved_tensors
        g = grad_out.to(ctx.dtype).reshape(idx.shape[0], -1)
        if g.is_cuda:
            return quad_sample_bwd(g.contiguous(), idx, w4, ctx.padded_shape, bins), None
        return quad_sample_bwd_plain(g, idx, w4, ctx.padded_shape), None


def grid_sample_2d_quad_kernel(features, coords):
    """Bilinear sample (align_corners=True, zeros padding) through the kernels.

    Same contract as the JAX package's ``grid_sample_2d_quad_pallas``:
    features (B, H, W, C), coords (B, ..., 2) normalized; returns
    coords.shape[:-1] + (C,), any C; differentiable in ``features``. CPU
    tensors take the plain versions.
    """
    if features.device.type not in ("cpu", "cuda") or coords.device != features.device:
        raise ValueError(f"grid_sample_2d_quad_kernel: features on "
                         f"{features.device}, coords on {coords.device}")
    return _QuadSample.apply(features, coords)
