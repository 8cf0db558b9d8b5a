"""Synthetic full-size inputs from numpy ``RandomState(seed)``: the JAX
package's ``__graft_entry__._vod_flagship`` batch, built the same way
(``flagship_batch``), and a nuScenes-shaped lidar batch for the multi-head
PointPillars config (``nuscenes_batch``)."""
from __future__ import annotations

import numpy as np

# VoD-like calibration of that batch
LIDAR_TO_CAM = [[0, -1, 0, 0.1], [0, 0, -1, -0.2], [1, 0, 0, 0.3], [0, 0, 0, 1]]
CAM_TO_IMG = [[700.0, 0, 960, 45.0], [0, 700, 250, -0.3], [0, 0, 1, 0.005]]


# (class id, count) of the gt boxes of a synthetic frame, padded to MAX_BOXES
# rows, and each class's anchor size (dx, dy, dz) and bottom height in the
# VoD config
GT_PER_CLASS = ((1, 3), (2, 2), (3, 2))
MAX_BOXES = 8
_CLASS_BOX = {1: ((3.9, 1.6, 1.56), -1.78), 2: ((0.8, 0.6, 1.73), -0.6),
              3: ((1.76, 0.6, 1.73), -0.6)}


def flagship_batch(cfg, b: int = 1, max_points: int = 8192, seed: int = 0,
                   cam_to_img=CAM_TO_IMG):
    """Radar points inside the range, a uniform-noise image of
    ``cfg.image_size``, the calibration above (or the intrinsics
    ``cam_to_img``, (3, 4)) and ``gt_boxes`` (B,
    MAX_BOXES, 8) [x, y, z, dx, dy, dz, heading, class id] with the boxes of
    ``GT_PER_CLASS`` (near their class anchor's size, inside the range) and
    zero padding rows, as numpy arrays. The boxes are drawn after everything
    else, so the served inputs do not depend on them."""
    rng = np.random.RandomState(seed)
    nf, pr = cfg.num_point_features, cfg.pc_range
    h, w = cfg.image_size
    pts = np.zeros((b, max_points, nf), np.float32)
    pts[..., 0] = rng.uniform(pr[0] + 0.5, pr[3] - 1.0, (b, max_points))
    pts[..., 1] = rng.uniform(pr[1] + 0.5, pr[4] - 0.5, (b, max_points))
    pts[..., 2] = rng.uniform(pr[2] + 0.5, pr[5] - 0.5, (b, max_points))
    pts[..., 3:nf - 2] = rng.randn(b, max_points, nf - 5)
    pts[..., nf - 2] = (rng.rand(b, max_points) > 0.5).astype(np.float32)
    pts[..., nf - 1] = 1.0
    images = rng.rand(b, h, w, 3).astype(np.float32)
    classes = [c for c, n in GT_PER_CLASS for _ in range(n)]
    gt = np.zeros((b, MAX_BOXES, 8), np.float32)
    for i in range(b):
        for j, cls in enumerate(classes):
            size, bottom = _CLASS_BOX[cls]
            dims = np.asarray(size) * rng.uniform(0.9, 1.1, 3)
            gt[i, j, 0] = rng.uniform(pr[0] + 5.0, pr[3] - 5.0)
            gt[i, j, 1] = rng.uniform(pr[1] + 5.0, pr[4] - 5.0)
            gt[i, j, 2] = bottom + dims[2] / 2
            gt[i, j, 3:6] = dims
            gt[i, j, 6] = rng.uniform(-np.pi, np.pi)
            gt[i, j, 7] = cls
    return {
        "points": pts,
        "points_valid": np.ones((b, max_points), bool),
        "images": images,
        "trans_lidar_to_cam": np.tile(np.array(LIDAR_TO_CAM, np.float32), (b, 1, 1)),
        "trans_cam_to_img": np.tile(np.array(cam_to_img, np.float32), (b, 1, 1)),
        "lidar_aug_matrix": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "gt_boxes": gt,
    }


# nuscenes_dataset.yaml: MAX_POINTS, MAX_GT_BOXES; a 10-sweep frame carries
# about 250-300k points after ego filtering
NUSCENES_MAX_POINTS = 327680
NUSCENES_MAX_BOXES = 128
NUSCENES_VALID = 0.85


def nuscenes_batch(cfg, b: int = 1, max_points: int = NUSCENES_MAX_POINTS,
                   max_boxes: int = NUSCENES_MAX_BOXES, boxes_per_frame: int = 40,
                   seed: int = 0):
    """A nuScenes-shaped frame batch: ``max_points`` rows of [x, y, z,
    intensity, timestamp], the first ``NUSCENES_VALID`` of them valid, their
    range from the ego exponential (mean 15 m; a lidar's density falls with
    range) and clipped to ``cfg.pc_range``; ``gt_boxes`` (B, max_boxes, 10)
    [x, y, z, dx, dy, dz, heading, vx, vy, class id], ``boxes_per_frame``
    boxes of classes drawn in turn, each near its class anchor's size and
    bottom height, and zero padding rows. numpy arrays."""
    rng = np.random.RandomState(seed)
    pr = cfg.pc_range
    n_valid = int(NUSCENES_VALID * max_points)
    pts = np.zeros((b, max_points, 5), np.float32)
    r = np.clip(rng.exponential(15.0, (b, n_valid)), 1.0, min(pr[3], pr[4]) - 0.5)
    phi = rng.uniform(-np.pi, np.pi, (b, n_valid))
    pts[:, :n_valid, 0] = np.clip(r * np.cos(phi), pr[0] + 0.05, pr[3] - 0.05)
    pts[:, :n_valid, 1] = np.clip(r * np.sin(phi), pr[1] + 0.05, pr[4] - 0.05)
    pts[:, :n_valid, 2] = rng.uniform(pr[2] + 0.5, pr[5] - 0.5, (b, n_valid))
    pts[:, :n_valid, 3] = rng.uniform(0, 255, (b, n_valid))
    pts[:, :n_valid, 4] = rng.choice(np.arange(10) * 0.05, (b, n_valid))
    valid = np.zeros((b, max_points), bool)
    valid[:, :n_valid] = True
    anchors = {c["class_name"]: c for c in cfg.anchor_generator}
    gt = np.zeros((b, max_boxes, 10), np.float32)
    for i in range(b):
        for j in range(min(boxes_per_frame, max_boxes)):
            cls = j % cfg.num_class
            a = anchors[cfg.class_names[cls]]
            dims = np.asarray(a["anchor_sizes"][0]) * rng.uniform(0.9, 1.1, 3)
            gt[i, j, 0] = rng.uniform(pr[0] + 3.0, pr[3] - 3.0)
            gt[i, j, 1] = rng.uniform(pr[1] + 3.0, pr[4] - 3.0)
            gt[i, j, 2] = a["anchor_bottom_heights"][0] + dims[2] / 2
            gt[i, j, 3:6] = dims
            gt[i, j, 6] = rng.uniform(-np.pi, np.pi)
            gt[i, j, 7:9] = rng.normal(0, 2.0, 2)
            gt[i, j, 9] = cls + 1
    return {"points": pts, "points_valid": valid, "gt_boxes": gt}
