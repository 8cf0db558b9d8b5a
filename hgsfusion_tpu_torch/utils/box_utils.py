"""BEV box geometry (counterpart of ``hgsfusion_tpu/utils/box_utils.py``):
corners and the nearest-axis BEV IoU of the target assigner.

Boxes are [x, y, z, dx, dy, dz, heading], heading about +z, x toward y.
"""
from __future__ import annotations

import math

import torch

from .common import device_constant, limit_period

# BEV corner template, counter-clockwise for heading 0
_CORNER_TEMPLATE_BEV = ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def boxes_to_corners_bev(boxes):
    """(..., 7) boxes -> (..., 4, 2) CCW BEV corners."""
    template = device_constant(_CORNER_TEMPLATE_BEV, boxes.dtype, boxes.device)
    dxy = boxes[..., None, 3:5] * template
    cosa = torch.cos(boxes[..., 6])[..., None]
    sina = torch.sin(boxes[..., 6])[..., None]
    x = dxy[..., 0] * cosa - dxy[..., 1] * sina
    y = dxy[..., 0] * sina + dxy[..., 1] * cosa
    return torch.stack([x, y], dim=-1) + boxes[..., None, 0:2]


def boxes_iou_normal(boxes_a, boxes_b):
    """Axis-aligned (..., N, 4) x (..., M, 4) [x1, y1, x2, y2] IoU ->
    (..., N, M); leading dims broadcast."""
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    x_len = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]),
                        min=0)
    y_len = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]),
                        min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    inter = x_len * y_len
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def boxes3d_lidar_to_aligned_bev_boxes(boxes3d):
    """Nearest-axis-aligned BEV boxes (..., 4): dx/dy swap when the heading,
    wrapped into [-pi/2, pi/2), is at least 45 degrees."""
    rot = torch.abs(limit_period(boxes3d[..., 6], offset=0.5, period=math.pi))
    swap = (rot >= math.pi / 4)[..., None]
    dxy = boxes3d[..., 3:5]
    dims = torch.where(swap, dxy.flip(-1), dxy)  # slices: a list index is a host copy
    return torch.cat([boxes3d[..., 0:2] - dims / 2, boxes3d[..., 0:2] + dims / 2], dim=-1)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """Nearest-axis BEV IoU used by the target assigner (MATCH_HEIGHT False)."""
    return boxes_iou_normal(boxes3d_lidar_to_aligned_bev_boxes(boxes_a),
                            boxes3d_lidar_to_aligned_bev_boxes(boxes_b))
