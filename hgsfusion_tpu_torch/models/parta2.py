"""Part-A2's pieces: the UNet decoder of the part-aware stage, the points'
features from its stride-1 voxels, the point part head with its targets
and loss, and the RoI-aware part aggregation head.

Counterpart of ``hgsfusion_tpu/models/parta2.py`` (``_upsample_to``,
``UNetDecoder``, ``PointPartHead``, ``gather_point_voxel_features``,
``part_targets``, ``part_head_loss``, ``PartA2RoIHead``). As there:

- the sparse UNet's decoder runs as dense masked 3-D convolutions: at each
  level the coarser volume is upsampled to the skip stage by a nearest
  gather at the integer indices ``min(i s // t, s - 1)`` (the stages are
  not exact doublings: 51 -> 26 -> 13 -> 6 planes), concatenated ``[up,
  skip]`` and run through two submanifold conv-BN-ReLUs on the skip's
  active set (``voxel_backbone._ConvBN3D``); the gather's gradient sums
  each source cell's targets in target order, without atomics;
- a point's feature is its stride-1 voxel's, 0 for an invalid point or
  one outside the grid;
- the RoI head pools ``[parts, score]`` (the part offsets zeroed where the
  segmentation score is under 0.3) by the mean and the point features by
  the max into each RoI's out^3 grid (``ops/roiaware_pool.py``), runs two
  masked 3x3x3 conv stacks over the cells any part feature reached, and
  flattens ``[x_rpn, x_part]`` in (x, y, z, channel) order into its FCs.

Parameter names are JAX's: ``up{4,3,2}_{a,b}`` (each ``0`` the
convolution, spconv layout, ``1`` its masked BN), ``cls_fc`` / ``part_fc``
(``FCStack``), ``cls_pred`` / ``part_pred``; ``conv_part{i}`` /
``conv_rpn{i}`` and their ``_bn``, ``shared_fc``, ``cls_fc``, ``reg_fc``,
``cls_pred``, ``reg_pred``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.points_in_boxes import points_in_boxes
from ..ops.roiaware_pool import pool_cells, roiaware_cells
from ..utils.common import device_constant
from .anchor_head import sigmoid_focal_loss
from .layers import MaskedBatchNorm, compute_dtype
from .pvrcnn import FCStack, linear
from .voxel_backbone import SparseConv3d, _ConvBN3D, points_to_voxel_ids


def upsample_index(s: int, t: int, device):
    """The nearest source of each of ``t`` targets over ``s`` sources,
    ``min(i s // t, s - 1)``, in integers."""
    i = torch.arange(t, device=device)
    return torch.clamp(torch.div(i * s, t, rounding_mode="floor"), max=s - 1)


def _run_sums(g, dim: int, s: int):
    """The gradient of a nearest gather along ``dim`` from ``s`` sources to
    ``g.shape[dim]`` targets (t >= s): source j sums its targets, which run
    from ceil(j t / s) to the next source's start, in target order."""
    t = g.shape[dim]
    j = torch.arange(s + 1, device=g.device)
    start = torch.div(j * t + s - 1, s, rounding_mode="floor")
    first, stop = start[:-1], start[1:]
    out = g.index_select(dim, first)
    shape = [1] * g.dim()
    shape[dim] = s
    for k in range(1, -(-t // s)):
        pos = first + k
        take = (pos < stop).view(shape)
        out = out + torch.where(take, g.index_select(dim, torch.clamp(pos, max=t - 1)),
                                torch.zeros((), dtype=g.dtype, device=g.device))
    return out


class _Upsample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, target_dhw):
        ctx.src_dhw = tuple(src.shape[1:4])
        return _gather(src, target_dhw)

    @staticmethod
    def backward(ctx, grad):
        for dim, s in zip((3, 2, 1), ctx.src_dhw[::-1]):
            grad = _run_sums(grad, dim, s)
        return grad, None


def _gather(src, target_dhw):
    d, h, w = src.shape[1:4]
    iz, iy, ix = (upsample_index(s, t, src.device) for s, t in zip((d, h, w), target_dhw))
    return src[:, iz[:, None, None], iy[None, :, None], ix[None, None, :]]


def upsample_to(src, target_dhw):
    """Nearest upsample of (B, d, h, w, C) to (B, D, H, W, C) at
    ``upsample_index``'s sources, each axis at least as fine as before."""
    target_dhw = tuple(int(v) for v in target_dhw)
    if torch.is_grad_enabled() and src.requires_grad:
        return _Upsample.apply(src, target_dhw)
    return _gather(src, target_dhw)


class UNetDecoder(nn.Module):
    """UNetV2's decoder, stride 8 -> 1: x_conv4 (64) upsampled to x_conv3
    and joined to it (``up4``, 64), then to x_conv2 (``up3``, 32), then to
    x_conv1 (``up2``, 16); each level as wide as its skip stage.
    ``stages`` -> (stride-1 features (B, D, H, W, 16), their active set)."""

    PLAN = (("x_conv3", 64, "up4"), ("x_conv2", 32, "up3"), ("x_conv1", 16, "up2"))

    def __init__(self, dtype=None):
        super().__init__()
        cin = 64
        for _, c, name in self.PLAN:
            setattr(self, f"{name}_a", _ConvBN3D(cin + c, c, dtype=dtype))
            setattr(self, f"{name}_b", _ConvBN3D(c, c, dtype=dtype))
            cin = c

    def forward(self, stages: Dict):
        x, mask, _ = stages["x_conv4"]
        for skip_name, _, name in self.PLAN:
            skip, mask, _ = stages[skip_name]
            h = torch.cat([upsample_to(x, skip.shape[1:4]), skip], dim=-1)
            x, _ = getattr(self, f"{name}_a")(h, mask)
            x, _ = getattr(self, f"{name}_b")(x, mask)
        return x, mask


def gather_point_voxel_features(voxels, points, valid, pc_range, voxel_size, grid_size):
    """Each point's (B, N, C) feature: its stride-1 voxel's in (B, D, H, W,
    C) ``voxels`` (the first nz planes: a point's flat voxel id is the same
    in the cropped and the whole volume), 0 where the point is invalid or
    outside the grid. The gather's gradient is ``index_put_``'s, no atomics."""
    ids, in_grid = points_to_voxel_ids(points[..., :3], valid, pc_range, voxel_size, grid_size)
    b, c = voxels.shape[0], voxels.shape[-1]
    ids = torch.where(in_grid, ids, torch.zeros_like(ids))
    out = voxels.reshape(b, -1, c)[torch.arange(b, device=ids.device)[:, None], ids]
    return out * in_grid[..., None].to(out.dtype)


class PointPartHead(nn.Module):
    """Per-point foreground logits (``cls_fc`` (128, 128) -> ``cls_pred``,
    (B, N, num_class)) and intra-object part offsets (``part_fc`` ->
    ``part_pred``, (B, N, 3) before the sigmoid), f32."""

    def __init__(self, in_channels: int, num_class: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.cls_fc = FCStack(in_channels, (128, 128), dtype)
        self.cls_pred = nn.Linear(128, num_class)
        self.part_fc = FCStack(in_channels, (128, 128), dtype)
        self.part_pred = nn.Linear(128, 3)

    def forward(self, feats):
        dt = compute_dtype(self.dtype)
        return (linear(self.cls_fc(feats), self.cls_pred, dt).float(),
                linear(self.part_fc(feats), self.part_pred, dt).float())


def part_targets(xyz, valid, gt_boxes, extra_width=(0.2, 0.2, 0.2)):
    """The points' part labels against (B, M, 8) gt boxes: ``cls`` (B, N)
    the first real box holding the point's class, 0 for background, -1 in
    a box's shell enlarged once by ``extra_width`` and on padded slots;
    ``part`` (B, N, 3) the point in that box's frame over its dims (at
    least 1e-3) plus 0.5, clipped to [0, 1]; ``fg`` (B, N)."""
    widths = device_constant(tuple(extra_width), gt_boxes.dtype, gt_boxes.device)
    cls, part, fg = [], [], []
    for f in range(xyz.shape[0]):
        pts, gts = xyz[f], gt_boxes[f]
        real = (gts[:, -1] > 0)[:, None]
        inb = points_in_boxes(pts, gts[:, :7]) & real
        big = torch.cat([gts[:, :3], gts[:, 3:6] + widths, gts[:, 6:7]], dim=-1)
        in_big = points_in_boxes(pts, big) & real
        f_fg = inb.any(0)
        ignored = in_big.any(0) & ~f_fg
        g = gts[inb.to(torch.uint8).argmax(0)]
        rel = pts - g[:, :3]
        c, s = torch.cos(-g[:, 6]), torch.sin(-g[:, 6])
        local = torch.stack([rel[:, 0] * c - rel[:, 1] * s, rel[:, 0] * s + rel[:, 1] * c,
                             rel[:, 2]], dim=-1)
        part.append(torch.clamp(local / torch.clamp(g[:, 3:6], min=1e-3) + 0.5, 0.0, 1.0))
        cls.append(torch.where(f_fg, g[:, -1].to(torch.int64),
                               torch.where(ignored, -1, 0)))
        fg.append(f_fg)
    cls = torch.stack(cls)
    return {"cls": torch.where(valid, cls, torch.full_like(cls, -1)), "part": torch.stack(part),
            "fg": torch.stack(fg) & valid}


def part_head_loss(cls_logits, part_pred, targets: Dict):
    """The point head's loss: the sigmoid focal loss of the logits against
    the labels' one-hot, weighted by ``cls >= 0`` (foreground and real
    background), over the foreground count (at least 1); and the BCE of
    sigmoid(part), clipped to [1e-6, 1 - 1e-6], against the part targets on
    the foreground, over 3 x that count. Returns (total, {"part_cls",
    "part_reg"})."""
    cls_t = targets["cls"]
    one_hot = F.one_hot(torch.clamp(cls_t - 1, min=0), cls_logits.shape[-1]).to(torch.float32)
    one_hot = one_hot * (cls_t > 0)[..., None].to(torch.float32)
    fgw = targets["fg"].to(torch.float32)
    n_fg = torch.clamp(fgw.sum(), min=1.0)
    care = (cls_t >= 0).to(torch.float32)
    loss_cls = sigmoid_focal_loss(cls_logits, one_hot, care).sum() / n_fg
    p = torch.clamp(torch.sigmoid(part_pred), 1e-6, 1 - 1e-6)
    t = targets["part"]
    bce = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    loss_part = (bce * fgw[..., None]).sum() / (3.0 * n_fg)
    return loss_cls + loss_part, {"part_cls": loss_cls, "part_reg": loss_part}


class PartA2RoIHead(nn.Module):
    """RoI-aware pooling of the parts (mean) and the point features (max)
    into each RoI's ``pool_size``^3 cells, a masked conv stack over each
    (``conv_part{i}`` / ``conv_rpn{i}``: 64 then ``num_features`` / 2, no
    bias, masked BN eps 1e-3 momentum 0.01, ReLU), the two joined and
    flattened, ``shared_fc`` (256, 256), then ``cls_fc`` -> ``cls_pred``
    (B, R) and ``reg_fc`` -> ``reg_pred`` (B, R, 7), f32. The reference
    pools at 12; JAX's default and the port's is 6 (``ROI_HEAD.POOL_SIZE``)."""

    def __init__(self, point_channels: int, pool_size: int = 6, num_features: int = 128,
                 seg_score_thresh: float = 0.3, dtype=None):
        super().__init__()
        self.dtype, self.pool_size, self.seg_score_thresh = dtype, pool_size, seg_score_thresh
        for name, cin in (("conv_part", 4), ("conv_rpn", point_channels)):
            for i, c in enumerate((64, num_features // 2)):
                setattr(self, f"{name}{i}", SparseConv3d(cin, c))
                setattr(self, f"{name}{i}_bn", MaskedBatchNorm(c))
                cin = c
        self.shared_fc = FCStack(pool_size ** 3 * num_features, (256, 256), dtype)
        self.cls_fc = FCStack(256, (256, 256), dtype)
        self.cls_pred = nn.Linear(256, 1)
        self.reg_fc = FCStack(256, (256, 256), dtype)
        self.reg_pred = nn.Linear(256, 7)

    def pools(self, rois, xyz, valid, point_feats, point_scores, point_parts):
        """(the parts' mean pool (B, R, o, o, o, 4), the point features' max
        pool (B, R, o, o, o, C))."""
        scr = point_scores[..., None]
        parts = torch.where(scr >= self.seg_score_thresh, point_parts,
                            torch.zeros((), dtype=point_parts.dtype, device=point_parts.device))
        cells = roiaware_cells(rois, xyz, valid, self.pool_size)
        return (pool_cells(cells, torch.cat([parts, scr], dim=-1), self.pool_size, "avg"),
                pool_cells(cells, point_feats, self.pool_size, "max"))

    def _conv_stack(self, name, h, mask):
        dt = compute_dtype(self.dtype)
        m = mask.to(dt)
        for i in range(2):
            h = getattr(self, f"{name}{i}")(h * mask.to(h.dtype), dt) * m
            h = torch.relu(getattr(self, f"{name}{i}_bn")(h, mask)) * m
        return h

    def forward(self, rois, xyz, valid, point_feats, point_scores, point_parts):
        b, r = rois.shape[:2]
        o = self.pool_size
        pooled_part, pooled_rpn = self.pools(rois, xyz, valid, point_feats, point_scores,
                                             point_parts)
        mask = (pooled_part != 0).any(dim=-1, keepdim=True).reshape(b * r, o, o, o, 1)
        x_part = self._conv_stack("conv_part", pooled_part.reshape(b * r, o, o, o, -1), mask)
        x_rpn = self._conv_stack("conv_rpn", pooled_rpn.reshape(b * r, o, o, o, -1), mask)
        h = self.shared_fc(torch.cat([x_rpn, x_part], dim=-1).reshape(b, r, -1))
        dt = compute_dtype(self.dtype)
        return (linear(self.cls_fc(h), self.cls_pred, dt)[..., 0].float(),
                linear(self.reg_fc(h), self.reg_pred, dt).float())
