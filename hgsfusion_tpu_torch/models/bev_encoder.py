"""Radar BEV encoder: the sparse ResNet-18 as dense masked convolutions, plus
the FPN_LSS neck.

Counterpart of ``hgsfusion_tpu/models/bev_encoder.py``. A submanifold conv
on a zero-background grid is a dense conv re-masked to the input's active
set; a strided sparse conv is a dense strided conv whose new active set is
the 3x3/2 max-pool of the old mask; spconv's BatchNorm1d over active rows is
``MaskedBatchNorm``. Parameter names and layouts follow the reference
(pcnres18 / lss_fpn): sparse conv weights are stored as spconv keeps them,
(O, kH, kW, I).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (MaskedBatchNorm, batch_norm, compute_dtype, conv_nhwc,
                     upsample_bilinear_align_corners)


def _dilate_mask_3x3_s2(mask):
    """New active set of a 3x3 stride-2 pad-1 sparse conv (NHWC mask)."""
    m = mask.to(torch.float32).permute(0, 3, 1, 2)
    return F.max_pool2d(m, 3, 2, 1).permute(0, 2, 3, 1).to(mask.dtype)


class SparseConv2d(nn.Module):
    """A 2-D sparse conv's parameters in spconv layout, applied densely."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, 3, 3, in_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x, dtype):
        """x (B, H, W, I) -> (B, H', W', O), 3x3 pad 1, in ``dtype``."""
        w = self.weight.to(dtype).permute(0, 3, 1, 2)
        b = None if self.bias is None else self.bias.to(dtype)
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w, b, self.stride, 1)
        return y.permute(0, 2, 3, 1)


class _SubMConvBN(nn.Sequential):
    """3x3 submanifold conv (with a bias unless ``bias`` is False) -> masked
    BN; output re-masked."""

    def __init__(self, in_channels: int, features: int, dtype=None, bias: bool = True):
        super().__init__(SparseConv2d(in_channels, features, bias=bias),
                         MaskedBatchNorm(features, eps=1e-3, momentum=0.01))
        self.dtype = dtype

    def forward(self, x, mask):
        m = mask.to(compute_dtype(self.dtype))
        y = self[0](x * m.to(x.dtype), compute_dtype(self.dtype)) * m
        y = self[1](y, mask)
        return y * m


class SparseBasicBlockV(nn.Module):
    """Entry block: conv0 -> relu, then (conv1 -> relu -> conv2) + identity."""

    def __init__(self, in_channels: int, features: int, dtype=None):
        super().__init__()
        self.conv0 = _SubMConvBN(in_channels, features, dtype)
        self.conv1 = _SubMConvBN(features, features, dtype)
        self.conv2 = _SubMConvBN(features, features, dtype)

    def forward(self, x, mask):
        x = torch.relu(self.conv0(x, mask))
        out = torch.relu(self.conv1(x, mask))
        out = self.conv2(out, mask)
        return torch.relu(out + x) * mask.to(out.dtype)


class SparseBasicBlock(nn.Module):
    """(conv1 -> relu -> conv2) + identity -> relu."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.conv1 = _SubMConvBN(features, features, dtype)
        self.conv2 = _SubMConvBN(features, features, dtype)

    def forward(self, x, mask):
        out = torch.relu(self.conv1(x, mask))
        out = self.conv2(out, mask)
        return torch.relu(out + x) * mask.to(out.dtype)


class _DownStage(nn.Sequential):
    """Reference stage layout: 0 SparseConv2d 3x3/2 (no bias), 1 BN,
    2 ReLU, 3... the stage's blocks (default: two residual blocks), each
    called as block(x, mask)."""

    def __init__(self, in_channels: int, features: int, dtype=None, blocks=None):
        if blocks is None:
            blocks = [SparseBasicBlock(features, dtype), SparseBasicBlock(features, dtype)]
        super().__init__(SparseConv2d(in_channels, features, stride=2, bias=False),
                         MaskedBatchNorm(features, eps=1e-3, momentum=0.01),
                         nn.ReLU(), *blocks)
        self.dtype = dtype

    def forward(self, x, mask):
        y = self[0](x, compute_dtype(self.dtype))
        new_mask = _dilate_mask_3x3_s2(mask)
        y = y * new_mask.to(y.dtype)
        y = torch.relu(self[1](y, new_mask)) * new_mask.to(y.dtype)
        for block in list(self)[3:]:
            y = block(y, new_mask)
        return y, new_mask


class PillarResNet18BEV(nn.Module):
    """SpMiddlePillarEncoder18: 4 stages at strides 1/2/4/8, channels
    32/64/128/256; returns the stages in ``out_indices``. In eval mode the
    stages past the last requested one are not run (their output would be
    discarded); in train mode they run without autograd, for their BN
    statistics."""

    def __init__(self, in_planes: int = 32, out_indices=(0, 1, 2), dtype=None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.conv1 = nn.Sequential(SparseBasicBlockV(in_planes, 32, dtype),
                                   SparseBasicBlock(32, dtype))
        self.conv2 = _DownStage(32, 64, dtype)
        self.conv3 = _DownStage(64, 128, dtype)
        self.conv4 = _DownStage(128, 256, dtype)

    def stages_without_grad(self):
        """The names of the stages that train mode runs without autograd."""
        return [f"conv{i + 2}" for i in range(3) if i >= max(self.out_indices)]

    def forward(self, x, mask):
        """x (B, H, W, C), mask (B, H, W, 1) float -> list of NHWC maps."""
        x = x.to(compute_dtype(self.dtype))
        x = self.conv1[1](self.conv1[0](x, mask), mask)
        outs = [x]
        for i, stage in enumerate((self.conv2, self.conv3, self.conv4)):
            if i < max(self.out_indices):
                x, mask = stage(x, mask)
                outs.append(x)
            elif self.training:
                # the JAX module runs every stage, so in train mode the unused
                # ones still update their batch statistics
                with torch.no_grad():
                    x, mask = stage(x, mask)
        return [outs[i] for i in self.out_indices]


class FPNLSS(nn.Module):
    """Top-down fuse of 3 BEV scales -> full-resolution radar BEV.

    ``conv34`` / ``conv23`` = (conv 3x3 no bias, BN, ReLU) x 2, indices
    0,1,3,4 as in lss_fpn; bilinear align_corners=True upsampling.
    """

    def __init__(self, in_channels=(32, 64, 128), out_channels=(128, 128),
                 scale_factor: int = 2, dtype=None):
        super().__init__()
        self.scale_factor = scale_factor
        self.dtype = dtype
        c1, c2, c3 = in_channels

        def block(cin, cout):
            return nn.Sequential(
                nn.Conv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout),
                nn.ReLU(),
                nn.Conv2d(cout, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout),
                nn.ReLU())

        self.conv34 = block(c2 + c3, out_channels[1])
        self.conv23 = block(c1 + out_channels[1], out_channels[0])

    def _convs(self, seq, x):
        dt = compute_dtype(self.dtype)
        for i in (0, 3):
            x = torch.relu(batch_norm(conv_nhwc(x, seq[i], dt), seq[i + 1], dt))
        return x

    def forward(self, feats):
        x1, x2, x3 = feats
        up3 = upsample_bilinear_align_corners(x3, self.scale_factor)
        x34 = self._convs(self.conv34, torch.cat([x2, up3], dim=-1))
        x34 = upsample_bilinear_align_corners(x34, self.scale_factor)
        return self._convs(self.conv23, torch.cat([x1, x34], dim=-1))


class PillarNetRadar(nn.Module):
    """Reader -> backbone -> neck container (the reference PillarNet).

    ``reader`` (the PillarFeatureNet) is held here for the reference's
    parameter names; ``forward`` runs backbone and neck on its output, as
    the JAX module does.
    """

    def __init__(self, reader=None, in_planes: int = 32, out_indices=(0, 1, 2),
                 neck_out_channels=(128, 128), dtype=None):
        super().__init__()
        if tuple(out_indices) != (0, 1, 2):
            raise NotImplementedError("FPN_LSS fuses stages (0, 1, 2)")
        if reader is not None:
            self.reader = reader
        self.backbone = PillarResNet18BEV(in_planes, out_indices, dtype)
        self.neck = FPNLSS((32, 64, 128), neck_out_channels, 2, dtype)

    def forward(self, pillar_bev, occ_mask):
        feats = self.backbone(pillar_bev, occ_mask.to(pillar_bev.dtype))
        return self.neck(feats)
