"""Shared building blocks, NHWC at the public boundary.

Counterpart of ``hgsfusion_tpu/models/layers.py``. Modules keep the
reference pcdet/torchvision parameter names; their forward takes and returns
channels-last tensors (B, H, W, C) and runs convolutions on a permuted NCHW
view, so no copy is made on either side. Every BatchNorm goes through
``batch_norm``, which follows its module's mode: running statistics in eval
mode (serving), batch statistics with flax's running-average update in train
mode.

A ``dtype`` of None computes in float32, as a flax module with no dtype
promotes bf16 activations against its f32 parameters.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def compute_dtype(dtype):
    return torch.float32 if dtype is None else dtype


def bn_eval(x, bn, dtype=None, dim: int = -1):
    """BatchNorm with running statistics along ``dim``, in ``dtype``
    (default: x's dtype). ``bn`` is any BatchNorm module."""
    dtype = x.dtype if dtype is None else dtype
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * scale
    shape = [1] * x.dim()
    shape[dim] = -1
    return torch.addcmul(shift.to(dtype).view(shape), x.to(dtype),
                         scale.to(dtype).view(shape))


def batch_norm(x, bn, dtype=None, dim: int = -1):
    """BatchNorm along ``dim`` in ``bn``'s mode, output in ``dtype`` (default:
    x's dtype). ``bn`` is any BatchNorm module; eval mode is ``bn_eval``.

    Train mode follows ``flax.linen.BatchNorm``, not torch: statistics over
    every axis but ``dim`` in f32, the variance as max(0, E[x^2] - E[x]^2)
    (flax's fast variance), and that *biased* variance both normalizes and
    enters the running average, with flax momentum 1 - ``bn.momentum``.
    """
    return batch_norm_joint((x,), bn, dtype, dim)[0]


def batch_norm_joint(xs, bn, dtype=None, dim: int = -1):
    """``batch_norm`` of the tensors ``xs`` as one call on them joined along
    every axis but ``dim``, without building the join: in train mode one set
    of batch statistics over all of them (each tensor's means weighted by
    its share of the rows) and one running-average update. Returns one output
    per input, in its shape."""
    if not bn.training:
        return [bn_eval(x, bn, dtype, dim) for x in xs]
    xfs, means, ex2s = [], [], []
    for x in xs:
        axes = [d for d in range(x.dim()) if d != dim % x.dim()]
        xf = x.to(torch.float32)
        xfs.append(xf)
        means.append(xf.mean(axes))
        ex2s.append((xf * xf).mean(axes))
    if len(xs) == 1:
        mean, ex2 = means[0], ex2s[0]
    else:
        rows = [x.numel() // x.shape[dim] for x in xs]
        shares = [n / sum(rows) for n in rows]
        mean = sum(m * s for m, s in zip(means, shares))
        ex2 = sum(e * s for e, s in zip(ex2s, shares))
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    with torch.no_grad():
        m = 1.0 - bn.momentum
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
        bn.num_batches_tracked += 1
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    out = []
    for x, xf in zip(xs, xfs):
        shape = [1] * x.dim()
        shape[dim] = -1
        out.append(((xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape))
                   .to(x.dtype if dtype is None else dtype))
    return out


class _MatmulF32(torch.autograd.Function):
    """a @ b of two half-precision CUDA matrices (or batches of them),
    accumulated and returned in f32 by one ``torch.mm`` / ``torch.bmm`` with
    ``out_dtype=float32``; its gradients are f32 products rounded once to
    the operands' dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().mT).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = (a.float().mT @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a, b):
    """(N, K) @ (K, O), or (B, N, K) @ (B, K, O), -> f32, never rounded to a
    narrower type: the ``einsum(..., preferred_element_type=float32)`` of
    the JAX package. A bf16/f16 pair on CUDA takes one mixed-precision
    product; elsewhere the operands are upcast (the CPU has no such
    product)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and b.dtype == a.dtype:
        return _MatmulF32.apply(a, b)
    return a.to(torch.float32) @ b.to(torch.float32)


def conv_nhwc(x, conv: nn.Conv2d, dtype):
    """``conv`` applied to a (B, H, W, C) tensor in ``dtype``."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), bias,
                 conv.stride, conv.padding, conv.dilation)
    return y.permute(0, 2, 3, 1)


class MaskedBatchNorm(nn.Module):
    """BatchNorm with statistics over masked (active) sites only.

    The torch BatchNorm1d over the compacted active rows of a sparse tensor:
    parameter names ``weight``/``bias``/``running_mean``/``running_var``,
    running stats updated as (1 - momentum) * old + momentum * batch with
    the unbiased batch variance stored and the biased one normalizing.
    """

    def __init__(self, features: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, mask, use_running_average: bool | None = None):
        """x (..., C); mask (..., 1) bool/float broadcastable to x. Batch
        statistics in train mode unless ``use_running_average`` says."""
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            m = mask.to(torch.float32)
            xf = x.to(torch.float32)
            dims = tuple(range(x.dim() - 1))
            count = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(dims) / count
            var = ((xf - mean) ** 2 * m).sum(dims) / count
            with torch.no_grad():
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
                self.num_batches_tracked += 1
        dt = x.dtype
        inv = torch.rsqrt(var + self.eps).to(dt)
        return (x - mean.to(dt)) * inv * self.weight.to(dt) + self.bias.to(dt)


class ConvBNReLU(nn.Module):
    """Conv2d -> BN -> ReLU (pcdet BasicBlock2D: ``conv``, ``bn``).

    The conv runs in ``dtype``; the BN, which has no dtype in the JAX module,
    in float32.
    """

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), dilation: int = 1, use_bias: bool = True,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1, dtype=None):
        super().__init__()
        pad = ((kernel_size[0] - 1) // 2 * dilation,
               (kernel_size[1] - 1) // 2 * dilation)
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, tuple(kernel_size),
                              tuple(strides), pad, dilation, bias=use_bias)
        self.bn = nn.BatchNorm2d(features, eps=bn_eps, momentum=bn_momentum)

    def forward(self, x):
        y = conv_nhwc(x, self.conv, compute_dtype(self.dtype))
        return torch.relu(batch_norm(y, self.bn, torch.float32))


class SEBlock(nn.Module):
    """Squeeze-and-excitation, ``att`` = (pool, 1x1 conv with bias); f32."""

    def __init__(self, features: int):
        super().__init__()
        self.att = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 nn.Conv2d(features, features, 1, bias=True))

    def forward(self, x):
        conv = self.att[1]
        g = x.mean(dim=(1, 2)).to(torch.float32)  # (B, C)
        g = F.linear(g, conv.weight[:, :, 0, 0], conv.bias)
        return x.to(torch.float32) * torch.sigmoid(g)[:, None, None, :]


def upsample_bilinear_align_corners(x, scale: int):
    """Bilinear x``scale`` upsample with align_corners=True (NHWC),
    separable gather-lerp as the JAX package computes it."""
    b, h, w, c = x.shape

    def axis_weights(n_in, n_out):
        if n_in == 1:
            idx0 = torch.zeros(n_out, dtype=torch.long, device=x.device)
            return idx0, idx0, torch.zeros(n_out, dtype=x.dtype, device=x.device)
        pos = torch.arange(n_out, dtype=torch.float32, device=x.device) * (n_in - 1) / (n_out - 1)
        i0 = torch.clamp(torch.floor(pos).long(), 0, n_in - 2)
        return i0, i0 + 1, (pos - i0).to(x.dtype)

    h0, h1, th = axis_weights(h, h * scale)
    x = x[:, h0] * (1 - th)[None, :, None, None] + x[:, h1] * th[None, :, None, None]
    w0, w1, tw = axis_weights(w, w * scale)
    return x[:, :, w0] * (1 - tw)[None, None, :, None] + x[:, :, w1] * tw[None, None, :, None]


def resize_bilinear(x, out_hw):
    """torch ``F.interpolate(mode='bilinear', align_corners=False)`` written
    out as the JAX package's gather-lerp (NHWC)."""
    h, w = x.shape[1:3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x

    def axis(n_in, n_out):
        src = torch.clamp(
            (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
            * (n_in / n_out) - 0.5, min=0.0)
        i0 = torch.clamp(torch.floor(src).long(), max=n_in - 1)
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        return i0, i1, (src - i0).to(x.dtype)

    y0, y1, ty = axis(h, oh)
    x0, x1, tx = axis(w, ow)
    r0 = x[:, y0]
    r1 = x[:, y1]
    rows = r0 + (r1 - r0) * ty[None, :, None, None]
    c0 = rows[:, :, x0]
    c1 = rows[:, :, x1]
    return c0 + (c1 - c0) * tx[None, None, :, None]
