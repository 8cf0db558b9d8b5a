"""Modulated deformable convolution (DCNv2), NHWC.

Counterpart of the JAX package's ``hgsfusion_tpu/ops/deform_conv.py``, itself
mmcv's ``ModulatedDeformConv2dPack`` as the reference's parallel-ASPP
occupancy head uses it (USE_DCN): a zero-initialized ``conv_offset``
predicts, per output pixel, each kernel tap's offset (dy, dx interleaved,
channels 0 to 2 k^2) and mask (sigmoid, the last k^2 channels); each tap
samples the input at the pixel + its dilated kernel position + its offset,
bilinearly with zeros padding, is scaled by its mask, and the taps are
contracted with the weights in one f32-accumulated product. Stride 1,
padding ``dilation * (k // 2)``, so H and W are kept.

No kernel of this package computes it: the JAX package leaves it to XLA,
and its offsets take a gradient through the sample, which none of the
port's samplers gives. So the sample is PyTorch's native bilinear sampler
(``torch.grid_sampler_2d``, the kernel behind ``F.grid_sample`` with
``align_corners=True`` and zeros padding) and the contraction
``matmul_f32``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..models.layers import compute_dtype, conv_nhwc
from .grid_sample import div_exact
from .matmul import matmul_f32


class ModulatedDeformConv2d(nn.Module):
    """mmcv's names: ``weight`` (O, C, k, k), ``bias`` (with ``bias``),
    ``conv_offset`` (Conv2d to 3 k^2 channels, zero-initialized)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, bias: bool = False, dtype=None):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.dilation, self.dtype = k, dilation, dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.conv_offset = nn.Conv2d(in_channels, 3 * k * k, k, padding=dilation * (k // 2),
                                     dilation=dilation, bias=True)
        nn.init.normal_(self.weight, 0.0, 1.0 / math.sqrt(in_channels * k * k))
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x):
        """x (B, H, W, C) -> (B, H, W, O) in the compute dtype."""
        b, h, w, c = x.shape
        k, d = self.kernel_size, self.dilation
        nk = k * k
        cdt = compute_dtype(self.dtype)
        om = conv_nhwc(x, self.conv_offset, cdt)
        off_y, off_x = om[..., 0:2 * nk:2], om[..., 1:2 * nk:2]
        mask = torch.sigmoid(om[..., 2 * nk:3 * nk])
        # each output pixel's taps: its position + the dilated kernel grid
        taps = torch.arange(-(k // 2), k // 2 + 1, dtype=torch.float32, device=x.device) * d
        base_yy, base_xx = torch.meshgrid(taps, taps, indexing="ij")
        ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None, None]
        xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :, None]
        py = ys + base_yy.reshape(-1) + off_y
        px = xs + base_xx.reshape(-1) + off_x
        u = div_exact(px, max(w - 1, 1)) * 2.0 - 1.0
        v = div_exact(py, max(h - 1, 1)) * 2.0 - 1.0
        grid = torch.stack([u, v], dim=-1).reshape(b, h * w, nk, 2)
        # the native kernel on every device (F.grid_sample may hand this mode
        # to cuDNN's sampler on CUDA tensors)
        sampled = torch.grid_sampler_2d(x.permute(0, 3, 1, 2).to(torch.float32), grid, 0, 0,
                                        True)  # (B, C, HW, nk)
        sampled = sampled.permute(0, 2, 3, 1) * mask.reshape(b, h * w, nk, 1)
        kernel = self.weight.permute(2, 3, 1, 0).reshape(nk * c, -1)  # (k, k, C, O)
        out = matmul_f32(sampled.to(cdt).reshape(b * h * w, nk * c), kernel.to(cdt)).to(cdt)
        if self.bias is not None:
            out = out + self.bias.to(cdt)
        return out.view(b, h, w, -1)
