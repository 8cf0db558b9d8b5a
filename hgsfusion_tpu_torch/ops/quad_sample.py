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
``quad_sample_taps`` runs that kernel's tap computation alone, so it can be
held against ``quad_indices`` bit for bit.

A CPU tensor takes the plain versions (``quad_sample_fwd_uv_plain``,
``ops/grid_sample.py``); a CUDA tensor launches the kernels or raises. The
coordinates get no gradient: the grid is calibration geometry, as in the JAX
package's ``_bwd``.
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
TAPS = "quad_sample_taps"
BWD_KERNEL = "quad_sample_bwd"
BINS = "quad_bins"
# launches of each kernel in this process, and the bins built on the card
# for the backward kernel (PyTorch calls, no kernel of this package);
# callers may reset them to 0
launches = {KERNEL: 0, REDUCE_KERNEL: 0, TAPS: 0, BWD_KERNEL: 0, BINS: 0}
# gather groups one launch of the fused kernel takes
MAX_REDUCE_GROUPS = 4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the fused entry's return when K's slice does not fit in shared memory
_K_SLICE_TOO_LARGE = -1


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PP, _PI = (ctypes.POINTER(t) for t in (_P, _I))
# each kernel's source in csrc/ and C arguments
_ENTRIES = {
    # uv, uv_stride, n, per_frame, map, b, h, w, c, out, idx_out, w4_out,
    # dtype, stream
    KERNEL: ("quad_sample", [_P, _I64, _I64, _I64, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P]),
    # uv, uv_stride, n, per_frame, maps, hs, ws, cs, k_offs (one entry per
    # group), groups, kmat, bias, out, o, dtype, stream
    REDUCE_KERNEL: ("quad_sample_reduce",
                    [_P, _I64, _I64, _I64, _PP, _PI, _PI, _PI, _PI, _I, _P, _P, _P, _I, _I, _P]),
    # uv, uv_stride, n, per_frame, h, w, idx, w4, dtype, stream
    TAPS: ("quad_sample_reduce", [_P, _I64, _I64, _I64, _I, _I, _P, _P, _I, _P]),
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
    """The backward kernel's launch contract; ``data`` is the cotangent."""
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


def _uv_rows(name, uv, b):
    """``uv`` (B, ..., 2) f32 on a CUDA device, read in place: every query's
    (x, y) a row of one stride (``grid[..., 0:2]`` of a contiguous grid has
    stride 3). Returns (n, queries per frame, row stride)."""
    if uv.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got uv on {uv.device}")
    if uv.dtype != torch.float32:
        raise TypeError(f"{name}: uv must be float32, got {uv.dtype}")
    if uv.dim() < 2 or uv.shape[-1] != 2 or uv.shape[0] != b:
        raise ValueError(f"{name}: bad shapes uv {tuple(uv.shape)} for maps of {b} frames")
    shape, strides = uv.shape, uv.stride()
    stride = want = strides[-2]
    for size, st in zip(reversed(shape[:-1]), reversed(strides[:-1])):
        if size != 1 and st != want:
            want = None
            break
        want *= size
    if strides[-1] != 1 or stride < 2 or want is None:
        raise ValueError(f"{name}: uv must be rows of (x, y) at one stride, got strides "
                         f"{uv.stride()}")
    n = uv.numel() // 2
    return n, n // b, stride


def quad_sample_fwd(features, uv, taps: bool = False):
    """Launch the forward kernel.

    ``features`` (B, H, W, C) unpadded and contiguous on the card (a map or
    channels that are not 16-byte aligned take the kernel's element path);
    ``uv`` (B, ..., 2) f32 sampling coordinates (x, y), normalized, read in
    place (rows of one stride: ``grid[..., 0:2]``) -> ``(out, idx, w4)``:
    ``out`` (N, C) in features' dtype, the bilinear samples (zeros padding,
    ``align_corners=True``) summed in f32 and rounded once; with ``taps``
    also ``quad_indices``' result, idx (N,) int32 and w4 (N, 4) f32, written
    by the same launch (else None and None). Same function as
    ``quad_sample_fwd_uv_plain`` up to the taps' rounding.
    """
    if features.device.type != "cuda":
        raise ValueError(f"{KERNEL} needs CUDA tensors, got {features.device}")
    if features.dtype not in _DTYPE_CODES:
        raise TypeError(f"{KERNEL}: unsupported dtype {features.dtype}")
    if features.dim() != 4 or min(features.shape) < 1:
        raise ValueError(f"{KERNEL}: bad shapes features {tuple(features.shape)}")
    if not features.is_contiguous():
        raise ValueError(f"{KERNEL}: features must be contiguous")
    b, h, w, c = features.shape
    if b * (h + 2) * (w + 2) >= 2**31:
        raise ValueError(f"{KERNEL}: padded map exceeds int32 pixel indexing")
    n, per_frame, stride = _uv_rows(KERNEL, uv, b)
    if uv.device != features.device:
        raise ValueError(f"{KERNEL}: uv must be on {features.device}")
    dev = features.device
    out = torch.empty((n, c), dtype=features.dtype, device=dev)
    idx = w4 = None
    if taps:
        idx = torch.empty(n, dtype=torch.int32, device=dev)
        w4 = torch.empty((n, 4), dtype=torch.float32, device=dev)
    err = _entry(KERNEL)(
        uv.data_ptr(), stride, n, per_frame, features.data_ptr(), b, h, w, c, out.data_ptr(),
        None if idx is None else idx.data_ptr(), None if w4 is None else w4.data_ptr(),
        _DTYPE_CODES[features.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    launches[KERNEL] += 1
    return out, idx, w4


def quad_sample_fwd_uv_plain(features, uv, taps: bool = False):
    """Plain version of ``quad_sample_fwd``, same arguments and result:
    ``quad_indices``, the zero-padded map and ``quad_sample_fwd_plain`` (the
    taps combined in the feature dtype)."""
    idx, w4 = quad_indices(features, uv)
    out = quad_sample_fwd_plain(F.pad(features, (0, 0, 1, 1, 1, 1)), idx, w4)
    return (out, idx, w4) if taps else (out, None, None)


def _check_reduce(uv, groups, kmat, bias):
    """The fused kernel's launch contract; returns (n, queries per frame,
    uv's row stride)."""
    name = REDUCE_KERNEL
    if not 1 <= len(groups) <= MAX_REDUCE_GROUPS:
        raise ValueError(f"{name}: {len(groups)} groups, takes 1 to {MAX_REDUCE_GROUPS}")
    if kmat.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got kmat on {kmat.device}")
    if kmat.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {kmat.dtype}")
    if kmat.dim() != 2 or bias.shape != (kmat.shape[1],):
        raise ValueError(f"{name}: bad shapes kmat {tuple(kmat.shape)} bias {tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name}: bias must be float32, got {bias.dtype}")
    b = groups[0][0].shape[0] if groups[0][0].dim() == 4 else -1
    for f, k_off in groups:
        if f.dtype != kmat.dtype:
            raise TypeError(f"{name}: map {f.dtype} and kmat {kmat.dtype} differ")
        if f.dim() != 4 or f.shape[0] != b or min(f.shape) < 1 \
                or not 0 <= k_off <= kmat.shape[0] - f.shape[-1]:
            raise ValueError(f"{name}: bad shapes map {tuple(f.shape)} at kmat rows {k_off} "
                             f"of {tuple(kmat.shape)}")
        if f.numel() >= 2**31:
            raise ValueError(f"{name}: map {tuple(f.shape)} exceeds int32 element indexing")
    for arg, t in [("kmat", kmat), ("bias", bias)] + [("map", f) for f, _ in groups]:
        if t.device != kmat.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {kmat.device}")
    n, per_frame, stride = _uv_rows(name, uv, b)
    if uv.device != kmat.device:
        raise ValueError(f"{name}: uv must be on {kmat.device}")
    return n, per_frame, stride


def quad_sample_reduce_fwd(uv, groups, kmat, bias):
    """Launch the fused kernel.

    ``uv`` (B, ..., 2) f32 sampling coordinates (x, y), normalized, read in
    place (``grid[..., 0:2]``); ``groups``: 1 to 4 pairs (map, k_off), each an
    unpadded contiguous map (B, H, W, c) in the compute dtype and its first
    row of ``kmat`` (sum c, O), contiguous in the compute dtype; ``bias``
    (O,) f32 -> (N, O) in the compute dtype: the bias plus each group's
    bilinear samples (taps computed from uv as ``quad_indices`` computes
    them, summed in f32 and rounded once to the compute dtype) times its
    rows of ``kmat``, every product summed in f32, rounded once. Same
    function as ``quad_sample_reduce_plain`` up to the taps' rounding and
    the order of the f32 sums.
    """
    n, per_frame, stride = _check_reduce(uv, groups, kmat, bias)
    o = kmat.shape[1]
    out = torch.empty((n, o), dtype=kmat.dtype, device=kmat.device)
    g = len(groups)
    maps = (_P * g)(*(f.data_ptr() for f, _ in groups))
    hs = (_I * g)(*(f.shape[1] for f, _ in groups))
    ws = (_I * g)(*(f.shape[2] for f, _ in groups))
    cs = (_I * g)(*(f.shape[3] for f, _ in groups))
    offs = (_I * g)(*(int(k_off) for _, k_off in groups))
    err = _entry(REDUCE_KERNEL)(
        uv.data_ptr(), stride, n, per_frame, maps, hs, ws, cs, offs, g, kmat.data_ptr(),
        bias.data_ptr(), out.data_ptr(), o, _DTYPE_CODES[kmat.dtype],
        torch.cuda.current_stream(kmat.device).cuda_stream)
    if err == _K_SLICE_TOO_LARGE:
        raise ValueError(f"{REDUCE_KERNEL}: the groups' rows of kmat {tuple(kmat.shape)} exceed "
                         f"the slice a block's shared memory holds")
    if err != 0:
        raise RuntimeError(f"{REDUCE_KERNEL} launch failed: cudaError {err}")
    launches[REDUCE_KERNEL] += 1
    return out


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


def quad_sample_taps(features, coords):
    """The fused kernel's tap computation alone: ``quad_indices``' result
    (idx (N,) int32 into the zero-padded map, w4 (N, 4) f32) for a map of
    ``features``' shape and dtype (its values are not read) and ``coords``
    (B, ..., 2) f32 on the card, read in place."""
    if features.device.type != "cuda" or features.dtype not in _DTYPE_CODES \
            or features.dim() != 4:
        raise ValueError(f"{TAPS}: features must be a (B, H, W, C) CUDA tensor of "
                         f"{list(_DTYPE_CODES)}, got {features.dtype} on {features.device}")
    b, h, w, _ = features.shape
    if b * (h + 2) * (w + 2) >= 2**31:
        raise ValueError(f"{TAPS}: padded map exceeds int32 pixel indexing")
    n, per_frame, stride = _uv_rows(TAPS, coords, b)
    if coords.device != features.device:
        raise ValueError(f"{TAPS}: coords must be on {features.device}")
    idx = torch.empty(n, dtype=torch.int32, device=coords.device)
    w4 = torch.empty((n, 4), dtype=torch.float32, device=coords.device)
    err = _entry(TAPS)(coords.data_ptr(), stride, n, per_frame, h, w, idx.data_ptr(),
                       w4.data_ptr(), _DTYPE_CODES[features.dtype],
                       torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{TAPS} launch failed: cudaError {err}")
    launches[TAPS] += 1
    return idx, w4


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
        grad = ctx.needs_input_grad[0]
        fwd = quad_sample_fwd if features.is_cuda else quad_sample_fwd_uv_plain
        # one launch on the card: coords read in place, the map as it is
        # (the model's maps are contiguous, so .contiguous() copies nothing)
        out, idx, w4 = fwd(features.contiguous(), coords, taps=grad)
        if grad:
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
