"""The second-stage RoI heads: SECOND-IoU's rotated BEV grid pool and IoU
head, and Voxel R-CNN's pool over the 3-D backbone's stages.

Counterpart of ``hgsfusion_tpu/models/roi_heads.py``
(``bilinear_sample_pixel``, ``rotated_bev_grid_pool``, ``SECONDIoUHead``,
``iou_head_loss``, ``rectified_scores``, ``VoxelRCNNPool``). As there:

- SECOND-IoU's pool is the reference's affine grid sample in closed form:
  a G x G grid over the rotated box with its end points on the box's
  edges, the align-corners pixel map, zeros outside the map, and the
  reference's centre at (c - range min) / cell without the half-texel
  shift;
- Voxel R-CNN pools each of x_conv2 .. x_conv4 as a voxel-centre point set
  around the 6^3 RoI grid points: a ball of 1.8 x the stage's cell size
  (the largest axis of ``voxel_size`` times the stride), 16 samples, an
  MLP (32, 32) and a max; here the ball is queried over each point's
  window of cells only (``ops/pointnet2.py::ball_query_grid``), which
  gives the dense query's indices.

Parameter names are JAX's: ``shared_fc{i}`` / ``shared_bn{i}``,
``iou_fc{i}`` / ``iou_bn{i}``, ``iou_pred``; ``pool_x_conv{2,3,4}`` (an
``SALayer``: ``mlp_r0.fc{j}`` / ``bn{j}``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .layers import batch_norm, compute_dtype
from .pvrcnn import SALayer, linear, roi_grid_points, soft_label_bce, stage_point_set


def bilinear_sample_pixel(feat, px, py):
    """(B, H, W, C) features at (B, N) pixel coordinates, bilinear with the
    align-corners convention (integer coordinates hit texel centres), zeros
    outside the map: (B, N, C)."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    x0, y0 = torch.floor(px), torch.floor(py)
    tx, ty = (px - x0)[..., None], (py - y0)[..., None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        g = torch.take_along_dim(flat, (yc * w + xc)[..., None], dim=1)
        return g * inb[..., None].to(g.dtype)

    return (tap(x0, y0) * (1 - tx) * (1 - ty) + tap(x0 + 1, y0) * tx * (1 - ty)
            + tap(x0, y0 + 1) * (1 - tx) * ty + tap(x0 + 1, y0 + 1) * tx * ty)


def rotated_bev_grid_pool(feats2d, rois, pc_range, voxel_size, down_ratio: int,
                          grid_size: int):
    """SECONDHead's rotated grid sample: (B, H, W, C) BEV features and (B,
    R, 7) RoIs -> (B, R, G G, C), the grid's end points on the box's edges,
    row-major over (yn, xn) in linspace(-1, 1, G)."""
    g = grid_size
    lin = torch.linspace(-1.0, 1.0, g, device=rois.device)
    yn, xn = torch.meshgrid(lin, lin, indexing="ij")
    xn, yn = xn.reshape(-1), yn.reshape(-1)
    cell_x, cell_y = voxel_size[0] * down_ratio, voxel_size[1] * down_ratio
    cx = ((rois[..., 0] - pc_range[0]) / cell_x)[..., None]
    cy = ((rois[..., 1] - pc_range[1]) / cell_y)[..., None]
    hx = (rois[..., 3] / 2.0 / cell_x)[..., None]
    hy = (rois[..., 4] / 2.0 / cell_y)[..., None]
    cr, sr = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    px = cx + hx * (cr * xn - sr * yn)
    py = cy + hy * (sr * xn + cr * yn)
    b, r = rois.shape[:2]
    out = bilinear_sample_pixel(feats2d, px.reshape(b, -1), py.reshape(b, -1))
    return out.reshape(b, r, g * g, -1)


class SECONDIoUHead(nn.Module):
    """Shared FCs (256, 256) and IoU FCs (256, 256), each with BN and ReLU
    (the reference's dropout left out, as JAX), over each RoI's flattened
    grid -> one IoU logit (B, R), f32."""

    def __init__(self, in_channels: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.layers = []
        for prefix in ("shared", "iou"):
            for i in range(2):
                setattr(self, f"{prefix}_fc{i}", nn.Linear(in_channels, 256, bias=False))
                setattr(self, f"{prefix}_bn{i}", nn.BatchNorm1d(256, eps=1e-5, momentum=0.1))
                self.layers.append((f"{prefix}_fc{i}", f"{prefix}_bn{i}"))
                in_channels = 256
        self.iou_pred = nn.Linear(256, 1)

    def forward(self, pooled):
        dt = compute_dtype(self.dtype)
        h = pooled.flatten(2)
        for fc, bn in self.layers:
            h = torch.relu(batch_norm(linear(h, getattr(self, fc), dt), getattr(self, bn), dt))
        return linear(h, self.iou_pred, dt)[..., 0].float()


def iou_head_loss(iou_logits, targets: Dict):
    """BCE of sigmoid(IoU logit) against the RoIs' soft IoU labels."""
    return soft_label_bce(iou_logits, targets)


def rectified_scores(cls_scores, iou_scores, score_type: str = "iou", iou_weight: float = 0.7):
    """The NMS score: "iou" the predicted IoU, "weighted_iou_cls" w iou +
    (1 - w) cls, "cls" the class score."""
    if score_type == "iou":
        return iou_scores
    if score_type == "weighted_iou_cls":
        return iou_weight * iou_scores + (1.0 - iou_weight) * cls_scores
    if score_type == "cls":
        return cls_scores
    raise ValueError(f"unknown SCORE_TYPE {score_type}")


class VoxelRCNNPool(nn.Module):
    """Features of VoxelBackBone8x's x_conv2, x_conv3 and x_conv4 (32, 64
    and 64 wide, at strides 2, 4, 8) at each RoI's 6^3 grid points: (B, R,
    216, 96)."""

    SOURCES = (("x_conv2", 2, 32), ("x_conv3", 4, 64), ("x_conv4", 8, 64))
    GRID = 6

    def __init__(self, pc_range, voxel_size, dtype=None):
        super().__init__()
        self.pc_range, self.voxel_size = tuple(pc_range), tuple(voxel_size)
        for name, stride, c in self.SOURCES:
            radius = 1.8 * stride * max(self.voxel_size)
            setattr(self, f"pool_{name}", SALayer(c, (radius,), (16,), ((32, 32),),
                                                  dtype=dtype))

    def forward(self, rois, stages: Dict):
        b, r = rois.shape[:2]
        grid = roi_grid_points(rois, self.GRID).reshape(b, r * self.GRID ** 3, 3)
        outs = []
        for name, _, _ in self.SOURCES:
            centers, feats, valid, geometry = stage_point_set(stages[name], self.pc_range,
                                                              self.voxel_size)
            outs.append(getattr(self, f"pool_{name}")(grid, centers, feats, valid,
                                                      grid=geometry))
        return torch.cat(outs, dim=-1).reshape(b, r, self.GRID ** 3, -1)
