"""The SECOND / PointPillars 2-D BEV backbone and the PillarNet RPN neck.

Counterpart of ``hgsfusion_tpu/models/base_bev_backbone.py``
(``BaseBEVBackbone``, ``RPNV2``). Every layer is a conv (or transposed conv)
without bias, a BatchNorm (eps 1e-3, flax momentum 0.99) and a ReLU. The
reference's names for these modules are not what the JAX package's
converter maps, so the parameters take the JAX package's names:
``block{i}_down_conv`` / ``_bn``, ``block{i}_layer{j}_conv`` / ``_bn``,
``deblock{i}_conv`` / ``_bn`` (RPNV2: ``block5_in``, ``block5_layer{j}``,
``deblock5``, ``deblock4``, ``block4_in``, ``block4_layer{j}``). NHWC at the
boundary; the convs run in the module's dtype, the BatchNorms take f32
statistics and give the compute dtype, as the flax BatchNorm with that
dtype does.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import batch_norm, compute_dtype, conv_nhwc


def conv_transpose_nhwc(x, conv: nn.ConvTranspose2d, dtype):
    """``conv`` (kernel = stride, no overlap) applied to a (B, H, W, C)
    tensor in ``dtype``."""
    y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), None,
                           conv.stride)
    return y.permute(0, 2, 3, 1)


class _Layers(nn.Module):
    """Named conv / BN pairs, each applied as conv, BN, ReLU (``cbr``); the
    BN gives the compute dtype, or f32 where ``BN_F32`` (the JAX package's
    ``layers.batch_norm``)."""

    BN_F32 = False

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype

    def add(self, name: str, conv: nn.Module, features: int):
        setattr(self, f"{name}_conv", conv)
        setattr(self, f"{name}_bn", nn.BatchNorm2d(features, eps=1e-3, momentum=0.01))

    def cbr(self, name: str, x):
        conv, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
        dt = compute_dtype(self.dtype)
        y = (conv_transpose_nhwc(x, conv, dt) if isinstance(conv, nn.ConvTranspose2d)
             else conv_nhwc(x, conv, dt))
        return torch.relu(batch_norm(y, bn, torch.float32 if self.BN_F32 else dt))


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


class BaseBEVBackbone(_Layers):
    """Per level: a stride-s 3x3 conv, then ``layer_nums[i]`` 3x3 convs, then
    a transposed conv up to the common stride; the levels concatenated along
    channels."""

    def __init__(self, in_channels: int = 64, layer_nums=(3, 5, 5), layer_strides=(2, 2, 2),
                 num_filters=(64, 128, 256), upsample_strides=(1, 2, 4),
                 num_upsample_filters=(128, 128, 128), dtype=None):
        super().__init__(dtype)
        self.levels = []
        cin = in_channels
        for li, (n, stride, feats) in enumerate(zip(layer_nums, layer_strides, num_filters)):
            self.add(f"block{li}_down", _conv3x3(cin, feats, stride), feats)
            for bi in range(n):
                self.add(f"block{li}_layer{bi}", _conv3x3(feats, feats), feats)
            up = upsample_strides[li]
            self.add(f"deblock{li}", nn.ConvTranspose2d(feats, num_upsample_filters[li], up, up,
                                                        bias=False), num_upsample_filters[li])
            self.levels.append(n)
            cin = feats

    @property
    def out_channels(self) -> int:
        return sum(getattr(self, f"deblock{li}_bn").num_features
                   for li in range(len(self.levels)))

    def forward(self, x):
        ups = []
        for li, n in enumerate(self.levels):
            x = self.cbr(f"block{li}_down", x)
            for bi in range(n):
                x = self.cbr(f"block{li}_layer{bi}", x)
            ups.append(self.cbr(f"deblock{li}", x))
        return torch.cat(ups, dim=-1)


class RPNV2(_Layers):
    """Two-level PillarNet neck: a conv stack on the coarse map, transposed
    2x up; one 3x3 conv on the fine map; the two concatenated and refined
    by a conv stack at the fine resolution."""

    def __init__(self, in_channels=(128, 256), layer_nums=(5, 5), num_filters=(128, 256),
                 num_upsample_filters=(128, 128), dtype=None):
        super().__init__(dtype)
        self.layer_nums = tuple(layer_nums)
        c4, c5 = in_channels
        self.add("block5_in", _conv3x3(c5, num_filters[1]), num_filters[1])
        for bi in range(layer_nums[1]):
            self.add(f"block5_layer{bi}", _conv3x3(num_filters[1], num_filters[1]),
                     num_filters[1])
        self.add("deblock5", nn.ConvTranspose2d(num_filters[1], num_upsample_filters[1], 2, 2,
                                                bias=False), num_upsample_filters[1])
        self.add("deblock4", _conv3x3(c4, num_upsample_filters[0]), num_upsample_filters[0])
        width = sum(num_upsample_filters)
        self.add("block4_in", _conv3x3(width, width), width)
        for bi in range(layer_nums[0]):
            self.add(f"block4_layer{bi}", _conv3x3(width, width), width)

    def forward(self, x_fine, x_coarse):
        """x_fine (B, H, W, C4), x_coarse (B, H/2, W/2, C5) -> (B, H, W,
        sum(num_upsample_filters))."""
        h5 = self.cbr("block5_in", x_coarse)
        for bi in range(self.layer_nums[1]):
            h5 = self.cbr(f"block5_layer{bi}", h5)
        h = torch.cat([self.cbr("deblock4", x_fine), self.cbr("deblock5", h5)], dim=-1)
        h = self.cbr("block4_in", h)
        for bi in range(self.layer_nums[0]):
            h = self.cbr(f"block4_layer{bi}", h)
        return h
