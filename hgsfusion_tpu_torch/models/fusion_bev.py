"""DSM modality sync: SE fusion of image and radar BEV features.

Counterpart of ``hgsfusion_tpu/models/fusion_bev.py::FusionAfterBEVSE``;
names follow FusionAfterBEVSEDirect: ``fuse_conv.{0: conv, 1: bn}`` and
``se_block.att.1``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .layers import SEBlock, batch_norm, compute_dtype, conv_nhwc, resize_bilinear


class FusionAfterBEVSE(nn.Module):
    """concat(image, radar) -> 3x3 conv + BN + ReLU -> SE block."""

    def __init__(self, in_channels: int = 256, image_out_channels: int = 128,
                 radar_out_channels: int = 128, dtype=None):
        super().__init__()
        c = image_out_channels + radar_out_channels
        self.dtype = dtype
        self.fuse_conv = nn.Sequential(nn.Conv2d(in_channels, c, 3, padding=1, bias=True),
                                       nn.BatchNorm2d(c), nn.ReLU())
        self.se_block = SEBlock(c)

    def forward(self, image_bev, radar_bev):
        if image_bev.shape[1:3] != radar_bev.shape[1:3]:
            image_bev = resize_bilinear(image_bev, radar_bev.shape[1:3])
        dt = compute_dtype(self.dtype)
        x = torch.cat([image_bev.to(radar_bev.dtype), radar_bev], dim=-1)
        x = torch.relu(batch_norm(conv_nhwc(x, self.fuse_conv[0], dt), self.fuse_conv[1], dt))
        return self.se_block(x)
