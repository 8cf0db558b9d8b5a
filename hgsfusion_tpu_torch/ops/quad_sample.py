"""The quad bilinear sampler kernels (``csrc/quad_sample.cu``,
``csrc/quad_sample_bwd.cu``) and their glue.

Counterpart of ``hgsfusion_tpu/ops/pallas_sample.py``. Its forward kernels
``_gather_combine`` (rows layout) and ``_gather_combine_planes`` (planes
layout) compute one function and become the one CUDA kernel
``quad_sample_fwd``; its backward kernels ``_scatter_outer`` and
``_scatter_outer_planes`` (with ``_unshift``) become ``quad_sample_bwd``. The
glue computes the top-left tap index and the four tap weights of every query
in PyTorch, as ``_indices`` does outside the TPU kernels: the weights in the
feature dtype, then carried in f32. The forward reads the four taps straight
from the zero-padded map, sums them in f32 and rounds once; the backward adds
the weighted cotangent onto an f32 padded map with atomics, and the glue crops
the ring and rounds once.

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
from .grid_sample import quad_sample_bwd_plain, quad_sample_fwd_plain, quad_taps

KERNEL = "quad_sample_fwd"
BWD_KERNEL = "quad_sample_bwd"
# launches of each kernel in this process; callers may reset them to 0
launches = {KERNEL: 0, BWD_KERNEL: 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _entry(source: str, name: str):
    fn = getattr(native.load(source), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
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
    err = _entry("quad_sample", KERNEL)(
        fp.data_ptr(), idx.data_ptr(), w4.data_ptr(), out.data_ptr(), n, c,
        fp.shape[2], _DTYPE_CODES[fp.dtype], torch.cuda.current_stream(fp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    launches[KERNEL] += 1
    return out


def quad_sample_bwd(grad_out, idx, w4, padded_shape):
    """Launch the backward kernel: ``grad_out`` (N, C) cotangent of the
    sampled rows, ``idx`` (N,) int32, ``w4`` (N, 4) f32, ``padded_shape``
    (B, H+2, W+2, C) -> the map's gradient (B, H, W, C) in grad_out's dtype.
    Same contract as ``quad_sample_bwd_plain``."""
    _check(BWD_KERNEL, grad_out, idx, w4)
    b, hp2, wp2, c = padded_shape
    if grad_out.shape != (idx.shape[0], c):
        raise ValueError(f"{BWD_KERNEL}: bad shapes grad_out {tuple(grad_out.shape)} "
                         f"for the padded map {tuple(padded_shape)}")
    acc = torch.zeros((b, hp2, wp2, c), dtype=torch.float32, device=grad_out.device)
    err = _entry("quad_sample_bwd", BWD_KERNEL)(
        grad_out.data_ptr(), idx.data_ptr(), w4.data_ptr(), acc.data_ptr(), idx.shape[0], c,
        wp2, _DTYPE_CODES[grad_out.dtype],
        torch.cuda.current_stream(grad_out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: cudaError {err}")
    launches[BWD_KERNEL] += 1
    return acc[:, 1:-1, 1:-1].to(grad_out.dtype)


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
            ctx.save_for_backward(idx, w4)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        idx, w4 = ctx.saved_tensors
        g = grad_out.to(ctx.dtype).reshape(idx.shape[0], -1)
        if g.is_cuda:
            return quad_sample_bwd(g.contiguous(), idx, w4, ctx.padded_shape), None
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
