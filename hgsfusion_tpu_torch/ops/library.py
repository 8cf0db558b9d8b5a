"""The kernels a served frame launches, as ``torch.library`` ops.

Three ops in the ``hgsfusion`` namespace, each with a CUDA implementation
(the kernel's launch, which raises on what the kernel does not take), a CPU
implementation (the kernel's plain version) and a fake one (the exact output
shape and dtype, all ``torch.export`` needs to trace it):

- ``hgsfusion::quad_sample_fwd(features, uv) -> out``: the sampler forward
  (``csrc/quad_sample.cu``) without the tap indices a gradient needs;
- ``hgsfusion::quad_sample_reduce_fwd(uv, maps, k_offs, kmat, bias) -> out``:
  the fused sampler + reduce of the gather view (``csrc/quad_sample_reduce.cu``);
- ``hgsfusion::quad_sample_depth_fwd(features, probs, grid) -> out``: the
  depth-weighted frustum sample of the gather view under USE_DEPTH
  (``csrc/quad_sample_depth.cu``) without what its backward needs;
- ``hgsfusion::nms_lazy(boxes, valid, nms_thresh, max_keep) -> keep``:
  rotated greedy NMS of a batch of score-sorted candidates
  (``csrc/nms_lazy.cu``): the suppression mask on every SM, then the
  greedy sweep, one block per frame;
- ``hgsfusion::quad_sample_reduce_q8_fwd(uv, maps, k_offs, kmat, bias) ->
  out``: the fused sampler + reduce on int8 maps (F2V QUANT int8), the
  per-channel scales folded into ``kmat`` by the caller
  (``csrc/quad_sample_reduce.cu``);
- ``hgsfusion::conv2d_w8a8(x, wt, ax, wk, kernel_size, stride, padding,
  dilation, dtype) -> out``: the int8 implicit-GEMM convolution of DDN
  QUANT w8a8 on x in the compute dtype, which its kernels quantize with
  the scale ax (``csrc/conv_int8.cu``);
- ``hgsfusion::farthest_point_sample(xyz, valid, k) -> idx``: masked
  farthest-point sampling of a batch of point sets, PV-RCNN's keypoints
  (``csrc/fps.cu``, a cluster of blocks a frame, ``fps_plan``).

So a frame served through these ops traces into one graph, with NMS inside
it and nothing read back to the host, which ``torch.export`` writes out
(``tools/export.py``). A serving host imports this module before
``torch.export.load`` (``tools/serve.py``): it registers the ops and carries
the kernel loader (``native.load``) and the launch wrappers, and imports no
model code. The plain versions live beside the Python entry points that
call the ops (``ops/quad_sample.py``, ``ops/nms.py``, ``ops/pointnet2.py``); the CPU
implementations import them at the call, since those modules import this
one.

This module also holds the launch wrappers the ops do not wrap: the
training routes' backward kernels (``quad_sample_bwd``,
``quad_sample_depth_bwd``), the fused kernel's tap computation alone
(``quad_sample_taps``, a check) and the int8 convolution's first pass
alone (``quantize_int8``, ``im2col_int8``: checks, counted as the
``quantize_int8`` launches ``conv2d_w8a8`` makes). Every wrapper counts its
launches in
``launches``, which also counts the bins built on the card for the backward
kernels (``quad_sample.quad_bins``, ``depth_sample.depth_bins``); callers
may reset them to 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import native

NAMESPACE = "hgsfusion"
KERNEL = "quad_sample_fwd"
REDUCE_KERNEL = "quad_sample_reduce_fwd"
TAPS = "quad_sample_taps"
BWD_KERNEL = "quad_sample_bwd"
BINS = "quad_bins"
NMS = "nms_lazy"  # the op; its two kernels:
NMS_MASK = "nms_mask"
NMS_SWEEP = "nms_sweep"
DEPTH_KERNEL = "quad_sample_depth_fwd"
DEPTH_BWD_KERNEL = "quad_sample_depth_bwd"
Q8_KERNEL = "quad_sample_q8_fwd"
REDUCE_Q8_KERNEL = "quad_sample_reduce_q8_fwd"
CONV_W8A8 = "conv2d_w8a8"
QUANTIZE_INT8 = "quantize_int8"
IM2COL_INT8 = "im2col_int8"  # a launch of QUANTIZE_INT8's first pass, counted as one
FPS = "fps"  # the op hgsfusion::farthest_point_sample
# launches of each kernel in this process, and the bins built on the card
# for the backward kernels (PyTorch calls, no kernel of this package)
launches = {KERNEL: 0, REDUCE_KERNEL: 0, TAPS: 0, BWD_KERNEL: 0, BINS: 0, NMS_MASK: 0,
            NMS_SWEEP: 0, DEPTH_KERNEL: 0, DEPTH_BWD_KERNEL: 0, Q8_KERNEL: 0, REDUCE_Q8_KERNEL: 0,
            CONV_W8A8: 0, QUANTIZE_INT8: 0, FPS: 0}
# depth bins the depth backward's phase 2 keeps in a shared-memory row
MAX_DEPTH_BINS = 128
# gather groups one launch of the fused kernel takes
MAX_REDUCE_GROUPS = 4

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the fused entry's return when K's slice does not fit in shared memory
_K_SLICE_TOO_LARGE = -1
# candidates of one NMS mask tile (one 64-bit word)
NMS_TILE = 64
# csrc/fps.cu's THREADS, its largest points a thread (the instantiations of
# fps_kernel) and MAX_CLUSTER: a block's threads, the points a thread keeps,
# the blocks of a frame's cluster
FPS_THREADS = 128
FPS_MAX_PTS = 32
FPS_MAX_CLUSTER = 16
FPS_MAX_POINTS = FPS_MAX_CLUSTER * FPS_THREADS * FPS_MAX_PTS
# the points a block of the FPS kernel takes where the cluster is not full
FPS_BLOCK_POINTS = 2048

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_PP, _PI = (ctypes.POINTER(t) for t in (_P, _I))
# each kernel's source in csrc/ and C arguments
_ENTRIES = {
    # uv, uv_stride, n, per_frame, map, b, h, w, c, out, idx_out, w4_out,
    # dtype, stream (Q8_KERNEL: an int8 map, dtype the output's)
    KERNEL: ("quad_sample", [_P, _I64, _I64, _I64, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P]),
    Q8_KERNEL: ("quad_sample", [_P, _I64, _I64, _I64, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P]),
    # uv, uv_stride, n, per_frame, maps, hs, ws, cs, k_offs (one entry per
    # group), groups, kmat, bias, out, o, dtype, stream
    REDUCE_KERNEL: ("quad_sample_reduce",
                    [_P, _I64, _I64, _I64, _PP, _PI, _PI, _PI, _PI, _I, _P, _P, _P, _I, _I, _P]),
    REDUCE_Q8_KERNEL: ("quad_sample_reduce",
                       [_P, _I64, _I64, _I64, _PP, _PI, _PI, _PI, _PI, _I, _P, _P, _P, _I, _I,
                        _P]),
    # x, wt, ax, wk, out, b, h, w, c, o, kh, kw, sh, sw, ph, pw, dh, dw, ho,
    # wo, kp, dtype (x's), out_f32, tile width, xq, stream
    CONV_W8A8: ("conv_int8", [_P] * 5 + [_I] * 19 + [_P, _P]),
    # x, ax, q, n, dtype, stream
    QUANTIZE_INT8: ("conv_int8", [_P, _P, _P, _I64, _I, _P]),
    # x, ax, q, b, h, w, c, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo, kp, dtype,
    # stream
    IM2COL_INT8: ("conv_int8", [_P] * 3 + [_I] * 16 + [_P]),
    # uv, uv_stride, n, per_frame, h, w, idx, w4, dtype, stream
    TAPS: ("quad_sample_reduce", [_P, _I64, _I64, _I64, _I, _I, _P, _P, _I, _P]),
    # ct, order, start, w4, out, b, h, w, c, dtype, stream
    BWD_KERNEL: ("quad_sample_bwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # boxes, valid, b, k, nms_thresh, mask, stream
    NMS_MASK: ("nms_lazy", [_P, _P, _I, _I, _F, _P, _P]),
    # mask, valid, b, k, max_keep, keep, stream
    NMS_SWEEP: ("nms_lazy", [_P, _P, _I, _I, _I, _P, _P]),
    # grid, grid_stride, n, per_frame, map, probs, b, h, w, c, d, out, key_out,
    # w4_out, dtype, stream
    DEPTH_KERNEL: ("quad_sample_depth",
                   [_P, _I64, _I64, _I64, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P]),
    # grid, grid_stride, n, per_frame, map, ct, order, start, rec, work,
    # work_len, rows, rows_len, b, h, w, c, d, out, dtype, stream
    DEPTH_BWD_KERNEL: ("quad_sample_depth",
                       [_P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _I64, _P, _I64, _I, _I, _I,
                        _I, _I, _P, _I, _P]),
    # xyz, valid, b, n, k, cluster, pts, out, stream
    FPS: ("fps", [_P, _P, _I, _I, _I, _I, _I, _P, _P]),
}


@functools.cache
def entry(name: str):
    """The C entry point of kernel ``name``, its library built first if
    needed."""
    source, argtypes = _ENTRIES[name]
    fn = getattr(native.load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _depth_work_entry():
    fn = native.load("quad_sample_depth").quad_sample_depth_bwd_work
    fn.argtypes = [_I64, _I, _I, _I, ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int64
    return fn


def depth_bwd_scratch(n: int, b: int, h: int, w: int) -> tuple[int, int]:
    """(int32 entries, f32 chunk rows) of the depth backward's phase-2 work
    list for n queries over a (b, h, w) map, as its source sizes them."""
    chunks = ctypes.c_int64()
    entries = _depth_work_entry()(n, b, h, w, ctypes.byref(chunks))
    return entries, chunks.value


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def uv_rows(name, uv, b):
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


def quad_sample_fwd(features, uv, taps: bool = False, dtype=None):
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

    An int8 map (F2V QUANT int8) takes the kernel's int8 instantiation
    (``quad_sample_q8_fwd``, counted apart): ``out`` in ``dtype`` holds the
    unscaled samples of its values, the weights rounded to ``dtype``, as
    ``quad_sample.quad_sample_q8_plain``.
    """
    q8 = features.dtype == torch.int8
    name = Q8_KERNEL if q8 else KERNEL
    if features.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {features.device}")
    out_dtype = dtype if q8 else features.dtype
    if out_dtype not in DTYPE_CODES or (not q8 and dtype not in (None, features.dtype)):
        raise TypeError(f"{name}: unsupported dtypes {features.dtype} -> {dtype}")
    if features.dim() != 4 or min(features.shape) < 1:
        raise ValueError(f"{name}: bad shapes features {tuple(features.shape)}")
    if not features.is_contiguous():
        raise ValueError(f"{name}: features must be contiguous")
    b, h, w, c = features.shape
    if b * (h + 2) * (w + 2) >= 2**31:
        raise ValueError(f"{name}: padded map exceeds int32 pixel indexing")
    n, per_frame, stride = uv_rows(name, uv, b)
    if uv.device != features.device:
        raise ValueError(f"{name}: uv must be on {features.device}")
    dev = features.device
    out = torch.empty((n, c), dtype=out_dtype, device=dev)
    idx = w4 = None
    if taps:
        idx = torch.empty(n, dtype=torch.int32, device=dev)
        w4 = torch.empty((n, 4), dtype=torch.float32, device=dev)
    err = entry(name)(
        uv.data_ptr(), stride, n, per_frame, features.data_ptr(), b, h, w, c, out.data_ptr(),
        None if idx is None else idx.data_ptr(), None if w4 is None else w4.data_ptr(),
        DTYPE_CODES[out_dtype], stream_of(features))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    return out, idx, w4


def _check_reduce(uv, groups, kmat, bias, name=REDUCE_KERNEL):
    """The fused kernel's launch contract (``name``'s: the int8 variant
    takes int8 maps); returns (n, queries per frame, uv's row stride)."""
    map_dtype = torch.int8 if name == REDUCE_Q8_KERNEL else kmat.dtype
    if not 1 <= len(groups) <= MAX_REDUCE_GROUPS:
        raise ValueError(f"{name}: {len(groups)} groups, takes 1 to {MAX_REDUCE_GROUPS}")
    if kmat.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got kmat on {kmat.device}")
    if kmat.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {kmat.dtype}")
    if kmat.dim() != 2 or bias.shape != (kmat.shape[1],):
        raise ValueError(f"{name}: bad shapes kmat {tuple(kmat.shape)} bias {tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name}: bias must be float32, got {bias.dtype}")
    b = groups[0][0].shape[0] if groups[0][0].dim() == 4 else -1
    for f, k_off in groups:
        if f.dtype != map_dtype:
            raise TypeError(f"{name}: map {f.dtype} and kmat {kmat.dtype} differ (the maps "
                            f"must be {map_dtype})")
        if f.dim() != 4 or f.shape[0] != b or min(f.shape) < 1 \
                or not 0 <= k_off <= kmat.shape[0] - f.shape[-1]:
            raise ValueError(f"{name}: bad shapes map {tuple(f.shape)} at kmat rows {k_off} "
                             f"of {tuple(kmat.shape)}")
        if f.numel() >= 2**31:
            raise ValueError(f"{name}: map {tuple(f.shape)} exceeds int32 element indexing")
    for arg, t in [("kmat", kmat), ("bias", bias)] + [("map", f) for f, _ in groups]:
        if t.device != kmat.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {kmat.device}")
    n, per_frame, stride = uv_rows(name, uv, b)
    if uv.device != kmat.device:
        raise ValueError(f"{name}: uv must be on {kmat.device}")
    return n, per_frame, stride


def _launch_reduce(name, uv, groups, kmat, bias):
    n, per_frame, stride = _check_reduce(uv, groups, kmat, bias, name)
    o = kmat.shape[1]
    out = torch.empty((n, o), dtype=kmat.dtype, device=kmat.device)
    g = len(groups)
    maps = (_P * g)(*(f.data_ptr() for f, _ in groups))
    hs = (_I * g)(*(f.shape[1] for f, _ in groups))
    ws = (_I * g)(*(f.shape[2] for f, _ in groups))
    cs = (_I * g)(*(f.shape[3] for f, _ in groups))
    offs = (_I * g)(*(int(k_off) for _, k_off in groups))
    err = entry(name)(
        uv.data_ptr(), stride, n, per_frame, maps, hs, ws, cs, offs, g, kmat.data_ptr(),
        bias.data_ptr(), out.data_ptr(), o, DTYPE_CODES[kmat.dtype], stream_of(kmat))
    if err == _K_SLICE_TOO_LARGE:
        raise ValueError(f"{name}: the groups' rows of kmat {tuple(kmat.shape)} exceed "
                         f"the slice a block's shared memory holds")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    return out


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
    return _launch_reduce(REDUCE_KERNEL, uv, groups, kmat, bias)


def quad_sample_reduce_q8_fwd(uv, groups, kmat, bias):
    """Launch the fused kernel on int8 maps (F2V QUANT int8): as
    ``quad_sample_reduce_fwd``, each group's map (B, H, W, c) int8 (the
    unscaled payload) and ``kmat`` in the compute dtype with each group's
    per-channel scales already folded into its rows. The taps' weights are
    rounded to the compute dtype, each group's samples summed in f32 and
    rounded once to it, then reduced as before. Same function as
    ``quad_sample.quad_sample_reduce_q8_plain`` up to the order of the f32
    sums."""
    return _launch_reduce(REDUCE_Q8_KERNEL, uv, groups, kmat, bias)


def tile_width(o: int) -> int:
    """The output channels of ``conv2d_w8a8``'s tile for O outputs: the
    narrowest of 64, 128 and 256 that holds O, else 256."""
    return 64 if o <= 64 else 128 if o <= 128 else 256


def conv2d_w8a8(x, wt, ax, wk, kernel_size, stride, padding, dilation, dtype):
    """Launch the int8 convolution that quantizes its own input: ``x`` (B,
    H, W, C) contiguous in f32, bf16 or f16, ``wt`` (O, Kp) int8 contiguous
    (``conv_int8.pack_weight``: row o the kernel's values in (ky, kx, c)
    order, zeros up to Kp, a multiple of 32), ``ax`` (1,) f32 the
    activation's scale, ``wk`` (O,) f32 the weights', all on one card;
    ``kernel_size``, ``stride``, ``padding``, ``dilation`` pairs -> (B, Ho,
    Wo, O) in ``dtype``: x quantized as clip(round(x / ax), -127, 127), the
    int32 sum of products converted to f32, times ``ax * wk``, rounded once
    (``dtype`` neither x's nor f32: kept in f32 by the kernel, then cast,
    which is the same rounding). A first launch quantizes x once (channels
    not a multiple of 16: into im2col rows) and counts as a launch of
    ``quantize_int8``; the tile is ``tile_width(O)`` outputs wide. Same
    function as ``conv_int8.conv2d_w8a8_plain``, bit for bit."""
    name = CONV_W8A8
    b, h, w, c, o, ho, wo = check_conv(x, wt, ax, wk, kernel_size, stride, padding, dilation,
                                       dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    for arg, t in (("x", x), ("wt", wt), ("ax", ax), ("wk", wk)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {x.device}")
    if wt.data_ptr() % 16:
        raise ValueError(f"{name}: wt must be 16-byte aligned")
    kp = wt.shape[1]
    # x's levels, or the im2col rows of them
    xq = torch.empty(x.numel() if c % 16 == 0 else b * ho * wo * kp, dtype=torch.int8,
                     device=x.device)
    out_f32 = dtype != x.dtype
    out = torch.empty((b, ho, wo, o), dtype=torch.float32 if out_f32 else dtype, device=x.device)
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    err = entry(name)(x.data_ptr(), wt.data_ptr(), ax.data_ptr(), wk.data_ptr(),
                      out.data_ptr(), b, h, w, c, o, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo,
                      kp, DTYPE_CODES[x.dtype], int(out_f32), tile_width(o), xq.data_ptr(),
                      stream_of(x))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[QUANTIZE_INT8] += 1
    launches[name] += 1
    return out.to(dtype)


def _check_first_pass(name, x, ax):
    if x.device.type != "cuda" or x.dtype not in DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float tensor on the card, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if ax.dtype != torch.float32 or ax.shape != (1,) or ax.device != x.device:
        raise ValueError(f"{name}: ax must be a (1,) float32 tensor on {x.device}")


def quantize_int8(x, ax):
    """Launch the first pass ``conv2d_w8a8`` runs on channels a multiple of
    16: ``x`` contiguous on the card in f32, bf16 or f16, ``ax`` (1,) f32
    -> int8 clip(round(x / ax), -127, 127) of x's shape. Same function as
    ``conv_int8.quantize``, bit for bit."""
    name = QUANTIZE_INT8
    _check_first_pass(name, x, ax)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    err = entry(name)(x.data_ptr(), ax.data_ptr(), q.data_ptr(), x.numel(),
                      DTYPE_CODES[x.dtype], stream_of(x))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    return q


def im2col_int8(x, ax, kernel_size, stride, padding, dilation, kp: int):
    """Launch the first pass ``conv2d_w8a8`` runs on channels that are not a
    multiple of 16 (the stem's 3): ``x`` (B, H, W, C) as ``quantize_int8``'s,
    the convolution's pairs and ``kp`` (a multiple of 32, at least kh kw C)
    -> (B Ho Wo, kp) int8, row m output pixel m's taps' levels in (ky, kx,
    c) order, zeros outside the map and past kh kw C. Counted as a launch of
    ``quantize_int8``. Same function as ``conv_int8.im2col_plain`` of
    ``conv_int8.quantize``, bit for bit."""
    name = IM2COL_INT8
    _check_first_pass(name, x, ax)
    if x.dim() != 4 or kp % 32 or not all(len(p) == 2 for p in (kernel_size, stride, padding,
                                                                 dilation)):
        raise ValueError(f"{name}: x must be (B, H, W, C), kp a multiple of 32 and the "
                         f"convolution's arguments pairs")
    b, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    q = torch.empty((b * ho * wo, kp), dtype=torch.int8, device=x.device)
    err = entry(name)(x.data_ptr(), ax.data_ptr(), q.data_ptr(), b, h, w, c, kh, kw, sh, sw,
                      ph, pw, dh, dw, ho, wo, kp, DTYPE_CODES[x.dtype], stream_of(x))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[QUANTIZE_INT8] += 1
    return q


def check_conv(x, wt, ax, wk, kernel_size, stride, padding, dilation, dtype):
    """The int8 convolution's argument contract (every device); returns (b,
    h, w, c, o, ho, wo)."""
    name = CONV_W8A8
    if x.dtype not in DTYPE_CODES or dtype not in DTYPE_CODES or wt.dtype != torch.int8:
        raise TypeError(f"{name}: x must be f32, bf16 or f16 and wt int8, the output f32, bf16 "
                        f"or f16; got {x.dtype}, {wt.dtype} and {dtype}")
    if ax.dtype != torch.float32 or wk.dtype != torch.float32:
        raise TypeError(f"{name}: ax and wk must be float32, got {ax.dtype} and {wk.dtype}")
    if not all(len(p) == 2 for p in (kernel_size, stride, padding, dilation)):
        raise ValueError(f"{name}: kernel_size, stride, padding and dilation are pairs")
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    if x.dim() != 4 or min(x.shape) < 1 or wt.dim() != 2:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} wt {tuple(wt.shape)}")
    b, h, w, c = x.shape
    o, kp = wt.shape
    k = kh * kw * c
    if min(kh, kw, sh, sw, dh, dw) < 1 or min(ph, pw) < 0 or kp % 32 or not k <= kp < k + 32 \
            or k > 133_144 or ax.shape != (1,) or wk.shape != (o,):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} wt {tuple(wt.shape)} ax "
                         f"{tuple(ax.shape)} wk {tuple(wk.shape)} for a {kh}x{kw} kernel "
                         f"(wt's rows: the kernel's {k} values padded to a multiple of 32; "
                         f"at most 133,144, so that the int32 sum cannot overflow)")
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{name}: no output for x {tuple(x.shape)} and a {kh}x{kw} kernel")
    return b, h, w, c, o, ho, wo


def check_nms(boxes, valid, max_keep: int):
    """The NMS op's argument contract (every device)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 7 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"{NMS}: bad shapes boxes {tuple(boxes.shape)} valid "
                         f"{tuple(valid.shape)}, want (B, K, 7) and (B, K)")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"{NMS}: boxes must be float32 and valid bool, got {boxes.dtype} "
                        f"and {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError(f"{NMS}: boxes on {boxes.device}, valid on {valid.device}")
    if max_keep < 0:
        raise ValueError(f"{NMS}: max_keep {max_keep} < 0")


def _check_nms_launch(name, valid, *tensors):
    """The NMS kernels' launch contract beyond ``check_nms``; returns (B,
    K, mask tiles)."""
    for t in (valid,) + tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: its tensors must be contiguous")
    b, k = valid.shape
    tiles = -(-k // NMS_TILE)
    if k * tiles >= 2**31:
        raise ValueError(f"{name}: {k} candidates' mask exceeds int32 indexing")
    if b > 65535:
        raise ValueError(f"{name}: {b} frames, takes at most 65,535")
    return b, k, tiles


def nms_mask(boxes, valid, nms_thresh: float):
    """Launch ``csrc/nms_lazy.cu``'s first kernel: ``boxes`` (B, K, 7) f32,
    score-sorted, and ``valid`` (B, K) bool, contiguous on the card -> the
    suppression mask (B, K, ceil(K / 64)) int64: bit j % 64 of word j // 64
    of row i set where candidates i < j are both valid and box i's BEV IoU
    with box j exceeds ``nms_thresh``. Only the words of a row tile (64
    candidates) holding a valid candidate, at and after its own tile, are
    written; the others hold what ``torch.empty`` left. Same bits as
    ``nms.nms_mask_plain`` there up to IoUs within rounding of
    ``nms_thresh``."""
    check_nms(boxes, valid, 0)
    b, k, tiles = _check_nms_launch(NMS_MASK, valid, boxes)
    mask = torch.empty((b, k, tiles), dtype=torch.int64, device=boxes.device)
    err = entry(NMS_MASK)(boxes.data_ptr(), valid.data_ptr(), b, k, nms_thresh,
                          mask.data_ptr(), stream_of(boxes))
    if err != 0:
        raise RuntimeError(f"{NMS_MASK} launch failed: cudaError {err}")
    launches[NMS_MASK] += 1
    return mask


def nms_sweep(mask, valid, max_keep: int):
    """Launch ``csrc/nms_lazy.cu``'s second kernel: the greedy sweep over
    ``nms_mask``'s words -> keep (B, K) bool, at most ``max_keep`` a frame;
    the function of ``nms.nms_sweep_plain``."""
    b, k, tiles = _check_nms_launch(NMS_SWEEP, valid, mask)
    if mask.shape != (b, k, tiles) or mask.dtype != torch.int64 or max_keep < 0:
        raise ValueError(f"{NMS_SWEEP}: mask {tuple(mask.shape)} {mask.dtype} for valid "
                         f"{tuple(valid.shape)}, max_keep {max_keep}")
    keep = torch.empty((b, k), dtype=torch.bool, device=valid.device)
    err = entry(NMS_SWEEP)(mask.data_ptr(), valid.data_ptr(), b, k, max_keep, keep.data_ptr(),
                           stream_of(valid))
    if err != 0:
        raise RuntimeError(f"{NMS_SWEEP} launch failed: cudaError {err}")
    launches[NMS_SWEEP] += 1
    return keep


def nms_lazy(boxes, valid, nms_thresh: float, max_keep: int):
    """Rotated greedy NMS on the card, two launches: ``boxes`` (B, K, 7)
    f32, each frame's candidates sorted by score, and ``valid`` (B, K) bool,
    contiguous on the card -> keep (B, K) bool: walking each frame's valid
    candidates in order, the ones kept, each suppressing every later one
    whose BEV IoU with it exceeds ``nms_thresh``; at most ``max_keep`` a
    frame. ``nms_mask`` writes the pairwise mask (8 B per 64 candidate pairs:
    2 MB a frame at 4,096) into scratch allocated here, ``nms_sweep`` walks
    it. Same keep sets as ``greedy_nms_lazy_plain`` up to IoUs within
    rounding of ``nms_thresh``. Raises where the mask's indexing would pass
    int32 (about 370,000 candidates)."""
    check_nms(boxes, valid, max_keep)
    return nms_sweep(nms_mask(boxes, valid, nms_thresh), valid, max_keep)


def fps_plan(n: int, threads: int = FPS_THREADS,
             block_points: int = FPS_BLOCK_POINTS) -> tuple[int, int]:
    """(cluster, pts): the FPS kernel's blocks a frame of ``n`` points and the
    points a thread keeps (a power of 2), each block a contiguous slice of
    ``threads * pts`` points, the last one partly filled. The cluster aims at
    ``block_points`` a block and is at most ``FPS_MAX_CLUSTER`` blocks; past
    that each thread keeps more points. Raises above what the largest
    cluster holds (``FPS_MAX_POINTS`` at ``FPS_THREADS``)."""
    cluster = min(FPS_MAX_CLUSTER, -(-n // block_points))
    pts = 1
    while cluster * threads * pts < n:
        pts *= 2
    if pts > FPS_MAX_PTS:
        raise ValueError(f"{FPS}: {n} points a frame, a cluster of the kernel holds at most "
                         f"{FPS_MAX_CLUSTER * threads * FPS_MAX_PTS}")
    return -(-n // (threads * pts)), pts


def check_fps(xyz, valid, k: int):
    """The FPS op's argument contract (every device)."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or valid.shape != xyz.shape[:2] \
            or xyz.shape[1] < 1:
        raise ValueError(f"{FPS}: bad shapes xyz {tuple(xyz.shape)} valid {tuple(valid.shape)}, "
                         f"want (B, N, 3) and (B, N), N >= 1")
    if xyz.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"{FPS}: xyz must be float32 and valid bool, got {xyz.dtype} and "
                        f"{valid.dtype}")
    if valid.device != xyz.device:
        raise ValueError(f"{FPS}: xyz on {xyz.device}, valid on {valid.device}")
    if k < 0:
        raise ValueError(f"{FPS}: k {k} < 0")


def farthest_point_sample(xyz, valid, k: int):
    """Launch ``csrc/fps.cu``: ``xyz`` (B, N, 3) f32 and ``valid`` (B, N)
    bool, contiguous on the card -> (B, k) int64, each frame's indices in
    selection order (a cluster of blocks a frame, ``fps_plan``; one launch
    a batch): index 0 first, then the valid point farthest from those
    chosen, ties to the lower index; invalid points only where the valid
    ones run out at distance 0 before them (index 0 where none is valid).
    Equal to ``pointnet2.farthest_point_sample_plain``. Raises for N above
    ``FPS_MAX_POINTS`` (65,536: a frame's points and their running minima
    stay in the registers of a cluster of 16 blocks)."""
    check_fps(xyz, valid, k)
    for t in (xyz, valid):
        if t.device.type != "cuda":
            raise ValueError(f"{FPS} needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{FPS}: its tensors must be contiguous")
    b, n = valid.shape
    cluster, pts = fps_plan(n)
    out = torch.empty((b, k), dtype=torch.int64, device=xyz.device)
    err = entry(FPS)(xyz.data_ptr(), valid.data_ptr(), b, n, k, cluster, pts, out.data_ptr(),
                     stream_of(xyz))
    if err != 0:
        raise RuntimeError(f"{FPS} launch failed: cudaError {err}")
    launches[FPS] += 1
    return out


def quad_sample_taps(features, coords):
    """The fused kernel's tap computation alone: ``quad_indices``' result
    (idx (N,) int32 into the zero-padded map, w4 (N, 4) f32) for a map of
    ``features``' shape and dtype (its values are not read) and ``coords``
    (B, ..., 2) f32 on the card, read in place."""
    if features.device.type != "cuda" or features.dtype not in DTYPE_CODES \
            or features.dim() != 4:
        raise ValueError(f"{TAPS}: features must be a (B, H, W, C) CUDA tensor of "
                         f"{list(DTYPE_CODES)}, got {features.dtype} on {features.device}")
    b, h, w, _ = features.shape
    if b * (h + 2) * (w + 2) >= 2**31:
        raise ValueError(f"{TAPS}: padded map exceeds int32 pixel indexing")
    n, per_frame, stride = uv_rows(TAPS, coords, b)
    if coords.device != features.device:
        raise ValueError(f"{TAPS}: coords must be on {features.device}")
    idx = torch.empty(n, dtype=torch.int32, device=coords.device)
    w4 = torch.empty((n, 4), dtype=torch.float32, device=coords.device)
    err = entry(TAPS)(coords.data_ptr(), stride, n, per_frame, h, w, idx.data_ptr(),
                       w4.data_ptr(), DTYPE_CODES[features.dtype],
                       stream_of(coords))
    if err != 0:
        raise RuntimeError(f"{TAPS} launch failed: cudaError {err}")
    launches[TAPS] += 1
    return idx, w4


def _check_bwd(name, data, idx, w4):
    """The backward kernel's launch contract; ``data`` is the cotangent."""
    if data.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {data.device}")
    if data.dtype not in DTYPE_CODES:
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


def quad_sample_bwd(grad_out, idx, w4, padded_shape, bins):
    """Launch the backward kernel: ``grad_out`` (N, C) cotangent of the
    sampled rows, ``idx`` (N,) int32, ``w4`` (N, 4) f32, ``padded_shape``
    (B, H+2, W+2, C), ``bins`` = ``quad_sample.quad_bins(idx, w4, padded_shape)`` -> the
    map's gradient (B, H, W, C) in grad_out's dtype. Same contract as
    ``quad_sample_bwd_plain``."""
    _check_bwd(BWD_KERNEL, grad_out, idx, w4)
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
    err = entry(BWD_KERNEL)(
        grad_out.data_ptr(), order.data_ptr(), start.data_ptr(), w4.data_ptr(), out.data_ptr(),
        b, hp2 - 2, wp2 - 2, c, DTYPE_CODES[grad_out.dtype],
        stream_of(grad_out))
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: cudaError {err}")
    launches[BWD_KERNEL] += 1
    return out


def _check_depth(name, features, depth_bins: int, grid, probs=None):
    """The depth kernels' launch contract on the map, its depth distribution
    (``probs``, or only its bin count) and the grid; returns (n, queries per
    frame, the grid's row stride)."""
    if features.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {features.device}")
    if features.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {features.dtype}")
    if features.dim() != 4 or min(features.shape) < 1 or not 1 <= depth_bins <= MAX_DEPTH_BINS \
            or (probs is not None and probs.shape != features.shape[:3] + (depth_bins,)):
        raise ValueError(f"{name}: bad shapes features {tuple(features.shape)}, "
                         f"{depth_bins} depth bins (1 to {MAX_DEPTH_BINS})"
                         + ("" if probs is None else f", probs {tuple(probs.shape)}"))
    if probs is not None and probs.dtype != features.dtype:
        raise TypeError(f"{name}: probs {probs.dtype} and features {features.dtype} differ")
    for arg, t in (("features", features), ("probs", probs)):
        if t is not None and (t.device != features.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous on {features.device}")
    b, h, w, _ = features.shape
    if b * (h + 2) * (w + 2) >= 2**31:
        raise ValueError(f"{name}: padded map exceeds int32 pixel indexing")
    if grid.shape[-1:] != (3,):
        raise ValueError(f"{name}: bad shapes grid {tuple(grid.shape)}, want (B, ..., 3)")
    n, per_frame, stride = uv_rows(name, grid[..., 0:2], b)
    if grid.device != features.device:
        raise ValueError(f"{name}: grid must be on {features.device}")
    return n, per_frame, stride


def quad_sample_depth_fwd(features, probs, grid, taps: bool = False):
    """Launch the depth-weighted sampler forward.

    ``features`` (B, H, W, C) and ``probs`` (B, H, W, D), D <= 128, contiguous
    on the card in one dtype (the compute dtype, as JAX casts the
    probabilities); ``grid`` (B, ..., 3) f32 normalized (u, v, z), read in
    place (rows of one stride) -> ``(out, key, w4)``: ``out`` (N, C) in
    features' dtype, each query's bilinear taps weighted by the depth lerp
    of its two bins at each tap, summed in f32 and rounded once; with
    ``taps`` also the bins' keys (N,) int32 and the effective tap weights
    (N, 4) f32 that the backward takes (else None and None). Same function
    as ``depth_sample.quad_sample_depth_fwd_plain`` up to the order of f32
    operations.
    """
    name = DEPTH_KERNEL
    if probs.dim() != 4:
        raise ValueError(f"{name}: bad shapes probs {tuple(probs.shape)}")
    n, per_frame, stride = _check_depth(name, features, probs.shape[3], grid, probs)
    b, h, w, c = features.shape
    dev = features.device
    out = torch.empty((n, c), dtype=features.dtype, device=dev)
    key = w4 = None
    if taps:
        key = torch.empty(n, dtype=torch.int32, device=dev)
        w4 = torch.empty((n, 4), dtype=torch.float32, device=dev)
    err = entry(name)(
        grid.data_ptr(), stride, n, per_frame, features.data_ptr(), probs.data_ptr(), b, h, w, c,
        probs.shape[3], out.data_ptr(), None if key is None else key.data_ptr(),
        None if w4 is None else w4.data_ptr(), DTYPE_CODES[features.dtype], stream_of(features))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    return out, key, w4


def quad_sample_depth_bwd(grad_out, features, grid, depth_bins: int, bins):
    """Launch the depth distribution's gradient: ``grad_out`` (N, C)
    cotangent of ``quad_sample_depth_fwd``'s output, ``features`` and
    ``grid`` as given to it, ``depth_bins`` D, ``bins`` = ``csr_bins`` of its
    keys -> the gradient of probs, (B, H, W, D) f32, every element summed in
    one fixed order. Same function as
    ``depth_sample.quad_sample_depth_bwd_plain`` up to that order."""
    name = DEPTH_BWD_KERNEL
    n, per_frame, stride = _check_depth(name, features, depth_bins, grid)
    b, h, w, c = features.shape
    if grad_out.dtype != features.dtype or grad_out.shape != (n, c) \
            or grad_out.device != features.device or not grad_out.is_contiguous():
        raise ValueError(f"{name}: grad_out must be a contiguous ({n}, {c}) {features.dtype} "
                         f"tensor on {features.device}, got {tuple(grad_out.shape)} "
                         f"{grad_out.dtype}")
    order, start = bins
    for arg, t, length in (("order", order, n), ("start", start, b * (h + 2) * (w + 2) + 1)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: bins {arg} must be int32, got {t.dtype}")
        if t.device != features.device or not t.is_contiguous() or t.shape != (length,):
            raise ValueError(f"{name}: bins {arg} must be a contiguous ({length},) tensor on "
                             f"{features.device}, got {tuple(t.shape)}")
    dev = features.device
    rec = torch.empty((n, 8), dtype=torch.float32, device=dev)
    entries, chunks = depth_bwd_scratch(n, b, h, w)
    work = torch.empty(entries, dtype=torch.int32, device=dev)
    rows = torch.empty(chunks * depth_bins, dtype=torch.float32, device=dev)
    out = torch.empty((b, h, w, depth_bins), dtype=torch.float32, device=dev)
    err = entry(name)(
        grid.data_ptr(), stride, n, per_frame, features.data_ptr(), grad_out.data_ptr(),
        order.data_ptr(), start.data_ptr(), rec.data_ptr(), work.data_ptr(), work.numel(),
        rows.data_ptr(), rows.numel(), b, h, w, c, depth_bins, out.data_ptr(),
        DTYPE_CODES[features.dtype], stream_of(features))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    return out


# -- the ops -----------------------------------------------------------------

def _sample_cuda(features: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    return quad_sample_fwd(features, uv)[0]


def _sample_cpu(features, uv):
    from . import quad_sample  # its attributes, read at the call
    return quad_sample.quad_sample_fwd_uv_plain(features, uv)[0]


def _sample_fake(features, uv):
    return features.new_empty((uv.numel() // 2, features.shape[-1]))


def _reduce_cuda(uv: torch.Tensor, maps: list[torch.Tensor], k_offs: list[int],
                 kmat: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return quad_sample_reduce_fwd(uv, list(zip(maps, k_offs)), kmat, bias)


def _reduce_cpu(uv, maps, k_offs, kmat, bias):
    from . import quad_sample
    return quad_sample.quad_sample_reduce_plain(uv, list(zip(maps, k_offs)), kmat, bias)


def _reduce_fake(uv, maps, k_offs, kmat, bias):
    return kmat.new_empty((uv.numel() // 2, kmat.shape[1]))


def _reduce_q8_cuda(uv: torch.Tensor, maps: list[torch.Tensor], k_offs: list[int],
                    kmat: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return quad_sample_reduce_q8_fwd(uv, list(zip(maps, k_offs)), kmat, bias)


def _reduce_q8_cpu(uv, maps, k_offs, kmat, bias):
    from . import quad_sample
    return quad_sample.quad_sample_reduce_q8_plain(uv, list(zip(maps, k_offs)), kmat, bias)


def _conv_cuda(x: torch.Tensor, wt: torch.Tensor, ax: torch.Tensor, wk: torch.Tensor,
               kernel_size: list[int], stride: list[int], padding: list[int],
               dilation: list[int], dtype: torch.dtype) -> torch.Tensor:
    return conv2d_w8a8(x, wt, ax, wk, kernel_size, stride, padding, dilation, dtype)


def _conv_cpu(x, wt, ax, wk, kernel_size, stride, padding, dilation, dtype):
    from . import conv_int8
    check_conv(x, wt, ax, wk, kernel_size, stride, padding, dilation, dtype)
    return conv_int8.conv2d_w8a8_plain(x, wt, ax, wk, kernel_size, stride, padding,
                                       dilation, dtype)


def _conv_fake(x, wt, ax, wk, kernel_size, stride, padding, dilation, dtype):
    b, _, _, _, o, ho, wo = check_conv(x, wt, ax, wk, kernel_size, stride, padding, dilation,
                                       dtype)
    return x.new_empty((b, ho, wo, o), dtype=dtype)


def _depth_cuda(features: torch.Tensor, probs: torch.Tensor,
                grid: torch.Tensor) -> torch.Tensor:
    return quad_sample_depth_fwd(features, probs, grid)[0]


def _depth_cpu(features, probs, grid):
    from . import depth_sample
    return depth_sample.quad_sample_depth_fwd_plain(features, probs, grid)[0]


def _depth_fake(features, probs, grid):
    return features.new_empty((grid.numel() // 3, features.shape[-1]))


def _nms_cuda(boxes: torch.Tensor, valid: torch.Tensor, nms_thresh: float,
              max_keep: int) -> torch.Tensor:
    return nms_lazy(boxes, valid, nms_thresh, max_keep)


def _nms_cpu(boxes, valid, nms_thresh, max_keep):
    from . import nms
    check_nms(boxes, valid, max_keep)
    keep = torch.zeros(valid.shape, dtype=torch.bool)
    for i in range(valid.shape[0]):
        keep[i] = nms.greedy_nms_lazy_plain(boxes[i], valid[i], nms_thresh, max_keep)
    return keep


def _nms_fake(boxes, valid, nms_thresh, max_keep):
    return valid.new_empty(valid.shape)


def _fps_cuda(xyz: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    return farthest_point_sample(xyz, valid, k)


def _fps_cpu(xyz, valid, k):
    from . import pointnet2
    check_fps(xyz, valid, k)
    return pointnet2.farthest_point_sample_plain(xyz, valid, k)


def _fps_fake(xyz, valid, k):
    return xyz.new_empty((xyz.shape[0], k), dtype=torch.int64)


def _register(name, cuda, cpu, fake):
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cuda, mutates_args=(),
                                 device_types="cuda")
    op.register_kernel("cpu")(cpu)
    op.register_fake(fake)
    return op


quad_sample_op = _register(KERNEL, _sample_cuda, _sample_cpu, _sample_fake)
quad_sample_reduce_op = _register(REDUCE_KERNEL, _reduce_cuda, _reduce_cpu, _reduce_fake)
nms_lazy_op = _register(NMS, _nms_cuda, _nms_cpu, _nms_fake)
quad_sample_depth_op = _register(DEPTH_KERNEL, _depth_cuda, _depth_cpu, _depth_fake)
quad_sample_reduce_q8_op = _register(REDUCE_Q8_KERNEL, _reduce_q8_cuda, _reduce_q8_cpu,
                                     _reduce_fake)
conv2d_w8a8_op = _register(CONV_W8A8, _conv_cuda, _conv_cpu, _conv_fake)
farthest_point_sample_op = _register("farthest_point_sample", _fps_cuda, _fps_cpu, _fps_fake)
