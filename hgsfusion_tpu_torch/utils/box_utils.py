"""Box geometry (counterpart of ``hgsfusion_tpu/utils/box_utils.py``): in
torch, the BEV corners and the nearest-axis BEV IoU of the target assigner;
in numpy, the corners, range mask and KITTI camera <-> lidar conversions of
the data and evaluation layers.

Boxes are [x, y, z, dx, dy, dz, heading], heading about +z, x toward y.
"""
from __future__ import annotations

import math

import numpy as np
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


# ---------------------------------------------------------------------------
# numpy versions of the JAX package's box_utils functions that the data and
# evaluation layers call (host code)
# ---------------------------------------------------------------------------

# corner template in the box frame, bottom ring first
_CORNER_TEMPLATE_3D = np.array(
    [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
     [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], dtype=np.float32) / 2.0


def rotate_points_along_z_np(points, angle):
    """Rotate (B, N, 3+C) points by (B,) angles about +z (x toward y):
    ``points @ R`` with R = [[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]]."""
    angle = np.asarray(angle)
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(cosa), np.ones_like(cosa)
    rot = np.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones],
                   axis=-1).reshape(*angle.shape, 3, 3)
    xyz = np.matmul(points[..., 0:3], rot.astype(points.dtype))
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def boxes_to_corners_3d(boxes3d):
    """(N, 7[+C]) boxes -> (N, 8, 3) corners."""
    corners = boxes3d[:, None, 3:6] * _CORNER_TEMPLATE_3D[None, :, :]
    corners = rotate_points_along_z_np(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def mask_boxes_outside_range_numpy(boxes, limit_range, use_center_to_filter=True,
                                   min_num_corners=1):
    """Keep-mask for boxes by center (or BEV corner count) inside range."""
    boxes = boxes[:, 0:7]
    limit_range = np.asarray(limit_range)
    if use_center_to_filter:
        centers = boxes[:, 0:3]
        return ((centers >= limit_range[0:3]) & (centers <= limit_range[3:6])).all(axis=-1)
    corners = boxes_to_corners_3d(boxes)[:, :, 0:2]
    mask = ((corners >= limit_range[0:2]) & (corners <= limit_range[3:5])).all(axis=2)
    return mask.sum(axis=1) >= min_num_corners


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) [x,y,z,l,h,w,ry] rect-camera boxes -> lidar
    [x,y,z,dx,dy,dz,heading] (z lifted by h/2, heading = -(ry + pi/2))."""
    boxes = np.array(boxes3d_camera, dtype=np.float32, copy=True)
    xyz_camera, r = boxes[:, 0:3], boxes[:, 6:7]
    l, h, w = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """Inverse of boxes3d_kitti_camera_to_lidar."""
    boxes = np.array(boxes3d_lidar, dtype=np.float32, copy=True)
    xyz_lidar = boxes[:, 0:3]
    l, w, h = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    xyz_lidar[:, 2] -= h.reshape(-1) / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) camera boxes -> (N, 8, 3) camera-frame corners: x/z rotated
    by ry about +y; y from 0/-h (bottom_center) or +-h/2."""
    boxes_num = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_corners = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]).T
    z_corners = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]).T
    if bottom_center:
        y_corners = np.zeros((boxes_num, 8), dtype=np.float32)
        y_corners[:, 4:8] = -h.reshape(boxes_num, 1).repeat(4, axis=1)
    else:
        y_corners = np.array([h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2]).T

    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(ry.size, dtype=np.float32), np.ones(ry.size, dtype=np.float32)
    rot_list = np.array([[np.cos(ry), zeros, -np.sin(ry)],
                         [zeros, ones, zeros],
                         [np.sin(ry), zeros, np.cos(ry)]])  # (3, 3, N)
    R = np.transpose(rot_list, (2, 0, 1))  # (N, 3, 3)
    temp = np.concatenate((x_corners.reshape(-1, 8, 1), y_corners.reshape(-1, 8, 1),
                           z_corners.reshape(-1, 8, 1)), axis=2)
    rotated = np.matmul(temp, R)
    x_loc, y_loc, z_loc = boxes3d[:, 0], boxes3d[:, 1], boxes3d[:, 2]
    rotated = rotated + np.stack([x_loc, y_loc, z_loc], axis=1)[:, None, :]
    return rotated.astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """Project camera boxes to 2D [x1, y1, x2, y2], clipped to the image."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners_in_image = pts_img.reshape(-1, 8, 2)
    min_uv = np.min(corners_in_image, axis=1)
    max_uv = np.max(corners_in_image, axis=1)
    boxes2d = np.concatenate([min_uv, max_uv], axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], 0, image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], 0, image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], 0, image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], 0, image_shape[0] - 1)
    return boxes2d
