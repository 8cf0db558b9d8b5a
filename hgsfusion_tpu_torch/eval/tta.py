"""Test-time augmentation (counterpart of ``hgsfusion_tpu/eval/tta.py``).

For each B=1 frame, ``tta_num`` randomly augmented copies are built (world
flip -> image-flip fusion -> rotation -> scaling, fresh draws from one
``RandomState(seed)`` in that order), the model runs on every copy, and each
copy's predictions are scored against that copy's *augmented* gt: there is
no inverse-transform ensembling, so the val set is evaluated ``tta_num``
times. The augmentations act on the static-padded sample arrays; padded
rows are zeros and stay ignorable (class 0 gt, invalid points). The same
seed gives the JAX package's variants bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..datasets.dataset import DatasetTemplate
from ..utils.box_utils import rotate_points_along_z_np


def _flip_x(sample, rng):
    enable = bool(rng.choice([False, True]))
    if enable:
        sample["points"][:, 1] = -sample["points"][:, 1]
        gt = sample["gt_boxes"]
        gt[:, 1] = -gt[:, 1]
        gt[:, 6] = -gt[:, 6]
    sample["flip_x"] = enable
    return sample


def _image_flip_fusion(sample, rng, calib):
    if not sample.get("flip_x", False):
        return sample
    if "images" not in sample:  # radar-only configs: no image to flip
        return sample
    img = sample["images"]
    w = img.shape[1]
    sample["images"] = np.ascontiguousarray(np.fliplr(img))
    gt = sample["gt_boxes"]
    valid = gt[:, -1] > 0
    if valid.any():
        img_pts, img_depth = calib.lidar_to_img(gt[valid, :3])
        img_pts[:, 0] = w - img_pts[:, 0]
        rect = calib.img_to_rect(img_pts[:, 0], img_pts[:, 1], img_depth)
        gt[valid, :3] = calib.rect_to_lidar(rect)
        gt[valid, 6] = -gt[valid, 6]
    return sample


def _rotation(sample, rng, rot_range=(-0.3926, 0.3926)):
    rot = rng.uniform(*rot_range)
    pts = sample["points"]
    pts[:, :] = rotate_points_along_z_np(pts[None], np.array([rot]))[0]
    gt = sample["gt_boxes"]
    gt[:, 0:3] = rotate_points_along_z_np(gt[None, :, 0:3], np.array([rot]))[0]
    gt[:, 6] += rot
    sample["noise_rot"] = rot
    return sample


def _scaling(sample, rng, scale_range=(0.95, 1.05)):
    scale = rng.uniform(*scale_range)
    sample["points"][:, :3] *= scale
    sample["gt_boxes"][:, :6] *= scale
    sample["noise_scale"] = scale
    return sample


def make_tta_variants(sample, calib, tta_num: int = 4, seed: int = 0):
    """One padded sample dict -> a list of ``tta_num`` augmented copies, each
    with its ``lidar_aug_matrix`` (which the view transform's BEV_AUG undoes)."""
    rng = np.random.RandomState(seed)
    variants = []
    for _ in range(tta_num):
        s = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in sample.items()}
        for k in ("lidar_aug_matrix", "flip_x", "noise_rot", "noise_scale"):
            s.pop(k, None)
        s = _flip_x(s, rng)
        s = _image_flip_fusion(s, rng, calib)
        s = _rotation(s, rng)
        s = _scaling(s, rng)
        s = DatasetTemplate.set_lidar_aug_matrix(s)
        for k in ("flip_x", "noise_rot", "noise_scale"):
            s.pop(k, None)
        variants.append(s)
    return variants
