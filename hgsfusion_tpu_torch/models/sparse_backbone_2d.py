"""The sparse 2-D pillar backbones as dense masked convolutions, and the
BEV backbone that reads two of their scales.

Counterpart of ``hgsfusion_tpu/models/sparse_backbone_2d.py``
(``_SubMBlock``, ``_DenseConvBNReLU``, ``_DenseBasicBlock``,
``PillarRes18BackBone8x``, ``_zero_stuff``, ``VoxelNeXt2DBackbone``,
``BaseBEVBackboneV1``), with the radar encoder's blocks
(``bev_encoder.SparseBasicBlock``, ``_SubMConvBN``, ``_DownStage``) as the
JAX package takes them from its ``bev_encoder.py``:

- ``PillarRes18BackBone8x`` (``residual=False``: PillarBackBone8x): four
  sparse stages at strides 1, 2, 4, 8 (residual or post-activation blocks),
  x_conv4 made dense, then a dense stride-16 stage x_conv5;
- ``VoxelNeXt2DBackbone``: six residual stages (3, 4, 6, 3, 3, 3 blocks,
  strides 1 to 32); the stride-16 and stride-32 maps placed on the stride-8
  grid at every second and fourth site (the dense image of the reference's
  index doubling, ``_zero_stuff``) and summed with x_conv4, a regular
  sparse 3x3 conv (``conv_out``, its active set dilated) and a submanifold
  ``shared_conv`` with a bias;
- ``BaseBEVBackboneV1``: x_conv5 through ``block1`` and a transposed-conv
  deblock, x_conv4 through its own deblock (a 1x1 transposed conv at stride
  1), the two concatenated and refined by ``block0``.

Parameter names: the stages as the radar encoder lays them out (``conv1``
a sequence of blocks; ``conv{i}`` a ``_DownStage``: 0 the strided conv, 1
its BN, 3... the blocks; a post-activation block ``0`` conv, ``1`` BN),
``conv5`` a sequence (0 the strided dense conv: ``conv``, ``bn``; then
``conv1``/``bn1``/``conv2``/``bn2`` residual blocks or ``conv``/``bn``
layers), ``conv_out`` and ``shared_conv`` each (0 conv, 1 BN); sparse conv
weights in spconv's (O, kH, kW, I) layout. ``BaseBEVBackboneV1`` keeps the
JAX package's ``block{i}_layer{j}_conv`` / ``_bn`` and ``deblock{i}_conv``
/ ``_bn``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base_bev_backbone import _conv3x3, _Layers
from .bev_encoder import SparseBasicBlock, SparseConv2d, _DownStage, _SubMConvBN
from .layers import MaskedBatchNorm, batch_norm, compute_dtype, conv_nhwc


class _SubMBlock(_SubMConvBN):
    """post_act_block (subm): a 3x3 submanifold conv without a bias -> BN ->
    ReLU, re-masked."""

    def __init__(self, in_channels: int, features: int, dtype=None):
        super().__init__(in_channels, features, dtype, bias=False)

    def forward(self, x, mask):
        y = super().forward(x, mask)
        return torch.relu(y) * mask.to(y.dtype)


class _DenseConvBNReLU(nn.Module):
    """post_act_block_dense: a dense 3x3 conv (no bias) -> BN (eps 1e-3,
    momentum 0.01, f32 out) -> ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, 3, stride, 1, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-3, momentum=0.01)

    def forward(self, x):
        y = conv_nhwc(x, self.conv, compute_dtype(self.dtype))
        return torch.relu(batch_norm(y, self.bn, torch.float32))


class _DenseBasicBlock(nn.Module):
    """The dense residual block at stride 1: both convs with a bias (the
    reference's bias = norm_fn is not None), BNs eps 1e-3, momentum 0.01."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-3, momentum=0.01)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-3, momentum=0.01)

    def forward(self, x):
        dt = compute_dtype(self.dtype)
        y = torch.relu(batch_norm(conv_nhwc(x, self.conv1, dt), self.bn1, torch.float32))
        y = batch_norm(conv_nhwc(y, self.conv2, dt), self.bn2, torch.float32)
        return torch.relu(y + x)


def _run(blocks, x, mask):
    for block in blocks:
        x = block(x, mask)
    return x


class PillarRes18BackBone8x(nn.Module):
    """(B, H, W, 32) pillar BEV + active mask (B, H, W, 1) -> (the maps
    {x_conv1 .. x_conv5}, their masks); x_conv4 is made dense (masked), and
    x_conv5 (stride 16) is dense with an all-true mask."""

    def __init__(self, residual: bool = True, dtype=None):
        super().__init__()
        self.dtype = dtype

        def block(cin, ch):
            return SparseBasicBlock(ch, dtype) if residual else _SubMBlock(cin, ch, dtype)

        self.conv1 = nn.Sequential(block(32, 32), block(32, 32))
        for i, (cin, ch) in enumerate(((32, 64), (64, 128), (128, 256)), start=2):
            setattr(self, f"conv{i}", _DownStage(cin, ch, dtype,
                                                 blocks=[block(ch, ch), block(ch, ch)]))
        tail = ([_DenseBasicBlock(256, dtype) for _ in range(2)] if residual
                else [_DenseConvBNReLU(256, 256, dtype=dtype) for _ in range(2)])
        self.conv5 = nn.Sequential(_DenseConvBNReLU(256, 256, stride=2, dtype=dtype), *tail)

    def forward(self, x, mask):
        x = _run(self.conv1, x.to(compute_dtype(self.dtype)), mask)
        outs, masks = {"x_conv1": x}, {"x_conv1": mask}
        for i in (2, 3, 4):
            x, mask = getattr(self, f"conv{i}")(x, mask)
            outs[f"x_conv{i}"], masks[f"x_conv{i}"] = x, mask
        x = outs["x_conv4"] * mask.to(x.dtype)
        outs["x_conv4"] = x
        for layer in self.conv5:
            x = layer(x)
        outs["x_conv5"] = x
        masks["x_conv5"] = torch.ones(x.shape[:3] + (1,), dtype=torch.bool, device=x.device)
        return outs, masks


def _zero_stuff(x, mask, factor: int, out_hw):
    """Features (B, h, w, C) and mask of a stride-8k map placed on the
    stride-8 grid ``out_hw`` at (factor i, factor j), zeros elsewhere (the
    dense image of the reference's ``indices *= factor``); rows and columns
    past the grid are dropped."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    nh, nw = (oh + factor - 1) // factor, (ow + factor - 1) // factor
    out = x.new_zeros((b, oh, ow, c))
    om = torch.zeros((b, oh, ow, 1), dtype=torch.bool, device=x.device)
    out[:, :factor * h:factor, :factor * w:factor] = (x * mask.to(x.dtype))[:, :nh, :nw]
    om[:, :factor * h:factor, :factor * w:factor] = mask.bool()[:, :nh, :nw]
    return out, om


def _dilate_3x3(mask):
    """The active set of a regular 3x3 stride-1 sparse conv (NHWC, bool)."""
    m = mask.to(torch.float32).permute(0, 3, 1, 2)
    return F.max_pool2d(m, 3, 1, 1).permute(0, 2, 3, 1) > 0


class VoxelNeXt2DBackbone(nn.Module):
    """(B, H, W, 32) pillar BEV + mask -> (features (B, H/8, W/8, 256), their
    active mask, {x_conv1 .. x_conv6}). The default 3x3 kernels only."""

    STAGES = ((2, 32, 64, 4), (3, 64, 128, 6), (4, 128, 256, 3), (5, 256, 256, 3),
              (6, 256, 256, 3))

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Sequential(*[SparseBasicBlock(32, dtype) for _ in range(3)])
        for i, cin, ch, n in self.STAGES:
            setattr(self, f"conv{i}", _DownStage(cin, ch, dtype,
                                                 blocks=[SparseBasicBlock(ch, dtype)
                                                         for _ in range(n)]))
        self.conv_out = nn.Sequential(SparseConv2d(256, 256, bias=False),
                                      MaskedBatchNorm(256, eps=1e-3, momentum=0.01))
        self.shared_conv = nn.Sequential(SparseConv2d(256, 256, bias=True),
                                         MaskedBatchNorm(256, eps=1e-5, momentum=0.1))

    def forward(self, x, mask):
        dt = compute_dtype(self.dtype)
        x = _run(self.conv1, x.to(dt), mask)
        stages = {"x_conv1": (x, mask)}
        for i, *_ in self.STAGES:
            x, mask = getattr(self, f"conv{i}")(x, mask)
            stages[f"x_conv{i}"] = (x, mask)
        x4, m4 = stages["x_conv4"]
        hw8 = x4.shape[1:3]
        x5, m5 = _zero_stuff(*stages["x_conv5"], 2, hw8)
        x6, m6 = _zero_stuff(*stages["x_conv6"], 4, hw8)
        merged = x4 * m4.to(x4.dtype) + x5 + x6
        omask = _dilate_3x3(m4.bool() | m5 | m6)
        om = omask.to(dt)
        y = self.conv_out[0](merged, dt) * om
        y = torch.relu(self.conv_out[1](y, omask)) * om
        z = self.shared_conv[0](y * om, dt) * om
        z = torch.relu(self.shared_conv[1](z, omask)) * om
        return z, omask, {k: v[0] for k, v in stages.items()}


class BaseBEVBackboneV1(_Layers):
    """x_conv4 (stride 8) and x_conv5 (stride 16) -> (B, H/8, W/8,
    num_filters[0]): each deblocked (a transposed conv of kernel = stride,
    BN, ReLU), ``block1`` (1 + layer_nums[1] 3x3 layers) on x_conv5 first,
    the two concatenated, then ``block0``. The BNs give f32, as JAX's."""

    BN_F32 = True

    def __init__(self, in_channels=(256, 256), layer_nums=(5, 5), num_filters=(256, 256),
                 upsample_strides=(1, 2), num_upsample_filters=(128, 128), dtype=None):
        super().__init__(dtype)
        self.layer_nums = tuple(layer_nums)
        c4, c5 = in_channels
        for idx, cin in ((0, sum(num_upsample_filters)), (1, c5)):
            for i in range(1 + layer_nums[idx]):
                self.add(f"block{idx}_layer{i}", _conv3x3(cin if i == 0 else num_filters[idx],
                                                          num_filters[idx]), num_filters[idx])
        for idx, cin in ((0, c4), (1, num_filters[1])):
            s = upsample_strides[idx]
            self.add(f"deblock{idx}", nn.ConvTranspose2d(cin, num_upsample_filters[idx], s, s,
                                                         bias=False),
                     num_upsample_filters[idx])

    @property
    def out_channels(self) -> int:
        return getattr(self, "block0_layer0_bn").num_features

    def _block(self, h, idx):
        for i in range(1 + self.layer_nums[idx]):
            h = self.cbr(f"block{idx}_layer{i}", h)
        return h

    def forward(self, x_conv4, x_conv5):
        ups = [self.cbr("deblock0", x_conv4),
               self.cbr("deblock1", self._block(x_conv5, 1))]
        return self._block(torch.cat(ups, dim=-1), 0)
