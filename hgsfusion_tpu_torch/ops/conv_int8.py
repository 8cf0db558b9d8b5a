"""DDN QUANT w8a8: the int8 convolution (``csrc/conv_int8.cu``) and its glue.

Counterpart of the JAX package's ``hgsfusion_tpu/models/resnet.py::QConv8``:
the activation is quantized per tensor and dynamically (``ax = max(max|x|,
1e-8) / 127``), the weights per output channel (``wk``), both as ``clip(
round(v / scale), -127, 127)`` in f32 with ties to even; the convolution is
int8 x int8 into int32, exact; the result ``f32(out) * (ax * wk)`` rounded
once to the compute dtype. So the port's output is JAX's bit for bit.

The activation's scale is one reduction in PyTorch (``activation_scale``:
the largest |x|, then the floor and the division on one value), which
reads nothing back to the host. The op ``hgsfusion::conv2d_w8a8`` takes x
in the compute dtype with that scale: on CUDA tensors its kernels quantize
x themselves, in a first pass over x (or into int8 im2col rows); on CPU
tensors ``conv2d_w8a8_plain`` quantizes as ``quantize`` does and convolves
the levels by ``F.conv2d`` in float64 (exact, |sum| <= 127^2 K < 2^53).
The quantized weights are kept on the ``nn.Conv2d`` and used again while
its ``weight`` is the same tensor at the same version, so a
``load_state_dict`` or any in-place update quantizes afresh; under
``torch.export`` they are computed in the graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.common import device_constant
from .grid_sample import div_exact
from .library import conv2d_w8a8_op

QMAX = 127


def activation_scale(x):
    """ax (1,) f32 of a float tensor: max(max|x|, 1e-8) / 127 over the whole
    tensor in one reduction. The largest |x| is one of x's values, so taking
    it over x's values cast to f32 gives JAX's maximum in x's dtype, cast."""
    amax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
    qmax = device_constant(float(QMAX), torch.float32, x.device)
    return torch.clamp(amax, min=1e-8).div_(qmax).reshape(1)


def quantize(x, ax):
    """int8 clip(round(x / ax), -127, 127), the quotient in f32, ties to
    even."""
    return torch.clamp(torch.round(x.to(torch.float32) / ax), -QMAX, QMAX).to(torch.int8)


def im2col_plain(q, kernel_size, stride, padding, dilation, kp):
    """Plain version of ``library.im2col_int8`` on the levels ``q`` (B, H,
    W, C) int8: (B Ho Wo, kp) int8, row m output pixel m's taps' levels in
    (ky, kx, c) order, zeros outside the map and past kh kw C."""
    b, _, _, c = q.shape
    taps = kernel_size[0] * kernel_size[1]
    cols = F.unfold(q.permute(0, 3, 1, 2).to(torch.float32), tuple(kernel_size),
                    tuple(dilation), tuple(padding), tuple(stride))
    rows = cols.view(b, c, taps, -1).permute(0, 3, 2, 1).reshape(-1, taps * c)
    return F.pad(rows, (0, kp - taps * c)).to(torch.int8)


def quantize_weight(weight):
    """(q int8 (O, I, kh, kw), wk (O,) f32) of a torch conv weight: wk =
    max(max|w|, 1e-8) / 127 per output channel, q = clip(round(w / wk),
    -127, 127)."""
    w = weight.detach().to(torch.float32)
    wk = div_exact(torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-8), float(QMAX))
    q = torch.clamp(torch.round(w / wk[:, None, None, None]), -QMAX, QMAX).to(torch.int8)
    return q, wk


def pack_weight(q):
    """int8 (O, I, kh, kw) -> (O, Kp): row o the kernel's values in (ky, kx,
    c) order, zeros up to Kp, the next multiple of 32 (the kernel's rows)."""
    o = q.shape[0]
    rows = q.permute(0, 2, 3, 1).reshape(o, -1)
    return F.pad(rows, (0, -rows.shape[1] % 32)).contiguous()


def conv2d_w8a8_plain(x, wt, ax, wk, kernel_size, stride, padding, dilation, dtype):
    """Plain version of ``library.conv2d_w8a8``, same arguments and
    result: x quantized by ``quantize`` with ``ax``, convolved by the
    packed weights ``wt`` on the integer values in float64 (exact), the sum
    to f32, times ``ax * wk`` in f32, rounded once to ``dtype``."""
    q = quantize(x, ax)
    kh, kw = kernel_size
    o = wt.shape[0]
    c = q.shape[-1]
    w = wt[:, :kh * kw * c].reshape(o, kh, kw, c).permute(0, 3, 1, 2)
    acc = F.conv2d(q.permute(0, 3, 1, 2).to(torch.float64), w.to(torch.float64), None,
                   tuple(stride), tuple(padding), tuple(dilation))
    out = acc.to(torch.float32) * (ax * wk)[None, :, None, None]
    return out.to(dtype).permute(0, 2, 3, 1).contiguous()


def _weights(conv):
    """``conv``'s packed int8 weights and scales, made again whenever its
    weight is another tensor or has changed in place. The cache holds the
    weight it was made from, so no other tensor can take its address."""
    w = conv.weight
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        q, wk = quantize_weight(w)
        return pack_weight(q), wk
    cached = getattr(conv, "_w8a8_cache", None)
    if cached is None or cached[0].data_ptr() != w.data_ptr() or cached[0].device != w.device \
            or cached[1] != w._version:
        q, wk = quantize_weight(w)
        cached = (w.detach(), w._version, pack_weight(q), wk)
        conv._w8a8_cache = cached
    return cached[2], cached[3]


def qconv2d(x, conv, dtype):
    """``QConv8``: the w8a8 convolution of an NHWC float tensor ``x`` by the
    ``nn.Conv2d`` ``conv`` (no bias; its stride, padding and dilation) ->
    NHWC in ``dtype``."""
    if conv.bias is not None:
        raise ValueError("QConv8 has no bias")
    x = x.contiguous()
    wt, wk = _weights(conv)
    return conv2d_w8a8_op(x, wt, activation_scale(x), wk, list(conv.kernel_size),
                          list(conv.stride), list(conv.padding), list(conv.dilation), dtype)
