"""Point feature encoding + data processing (numpy, CPU side); a copy of
``hgsfusion_tpu/datasets/processor.py``, its configs plain dicts.

Reference: pcdet/datasets/processor/point_feature_encoder.py:4-57 and
data_processor.py:64-301 (only the processors the HGS configs use:
mask_points_and_boxes_outside_range, calculate_grid_size, shuffle_points).
"""
from __future__ import annotations

import numpy as np

from ..utils import box_utils


class PointFeatureEncoder:
    """xyz-first feature selection (absolute_coordinates_encoding).

    The reference (point_feature_encoder.py:43-57) ALWAYS emits x,y,z as
    the first three columns and then appends the non-xyz used features in
    used_feature_list order — regardless of where (or whether) xyz appears
    in used_feature_list. Selecting used columns verbatim would let a
    config like ['intensity','x','y','z'] put non-coordinates in the first
    three columns, which every downstream consumer reads as coordinates."""

    def __init__(self, config, point_cloud_range=None):
        self.config = config
        assert list(config["src_feature_list"][0:3]) == ["x", "y", "z"]
        self.used = list(config["used_feature_list"])
        self.src = list(config["src_feature_list"])

    @property
    def num_point_features(self) -> int:
        return 3 + sum(1 for f in self.used if f not in ("x", "y", "z"))

    def forward(self, data_dict):
        cols = [0, 1, 2] + [
            self.src.index(f) for f in self.used if f not in ("x", "y", "z")
        ]
        data_dict["points"] = data_dict["points"][:, cols]
        data_dict["use_lead_xyz"] = True
        return data_dict


class DataProcessor:
    """Ordered queue of processing steps driven by config NAMEs."""

    def __init__(self, processor_configs, point_cloud_range, training: bool,
                 num_point_features: int):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.grid_size = None
        self.voxel_size = None
        self.steps = []
        for cfg in processor_configs:
            self.steps.append((getattr(self, cfg["NAME"]), cfg))

    def mask_points_and_boxes_outside_range(self, data_dict, config):
        pts = data_dict["points"]
        rng = self.point_cloud_range
        keep = (
            (pts[:, 0] >= rng[0]) & (pts[:, 0] <= rng[3])
            & (pts[:, 1] >= rng[1]) & (pts[:, 1] <= rng[4])
        )
        data_dict["points"] = pts[keep]
        if (
            data_dict.get("gt_boxes", None) is not None
            and config.get("REMOVE_OUTSIDE_BOXES", False)
            and self.training
        ):
            mask = box_utils.mask_boxes_outside_range_numpy(
                data_dict["gt_boxes"], rng,
                use_center_to_filter=config.get("USE_CENTER_TO_FILTER", True),
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][mask]
            if data_dict.get("gt_boxes2d", None) is not None:
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][mask]
        return data_dict

    def calculate_grid_size(self, data_dict, config):
        if self.grid_size is None:
            voxel_size = np.asarray(config["VOXEL_SIZE"], np.float32)
            extent = self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
            self.grid_size = np.round(extent / voxel_size).astype(np.int64)
            self.voxel_size = voxel_size
        return data_dict

    def transform_points_to_voxels(self, data_dict, config):
        """Host-side voxelization (spconv VoxelGeneratorWrapper equivalent,
        data_processor.py:133-215): bucketize points into voxels in point
        order, cap points/voxel and total voxels. Output: voxels (V, P, C),
        voxel_coords (V, 3) zyx, voxel_num_points (V,). Kept for
        reference-config compatibility — the TPU model families voxelize
        on-device from the raw padded points instead."""
        voxel_size = np.asarray(config["VOXEL_SIZE"], np.float32)
        extent = self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
        grid = np.round(extent / voxel_size).astype(np.int64)
        if self.grid_size is None:
            self.grid_size = grid
            self.voxel_size = voxel_size
        pts = data_dict["points"]
        max_ppv = int(config["MAX_POINTS_PER_VOXEL"])
        max_v = int(config["MAX_NUMBER_OF_VOXELS"][self.mode])
        idx3 = np.floor(
            (pts[:, :3] - self.point_cloud_range[:3]) / voxel_size
        ).astype(np.int64)
        inb = np.all((idx3 >= 0) & (idx3 < grid), axis=1)
        pts_in = pts[inb]
        idx3 = idx3[inb]
        flat = (idx3[:, 2] * grid[1] + idx3[:, 1]) * grid[0] + idx3[:, 0]
        # first-appearance voxel order (spconv semantics: point order)
        uniq, first_idx, inv = np.unique(
            flat, return_index=True, return_inverse=True)
        order = np.argsort(first_idx)
        rank_of_uniq = np.empty_like(order)
        rank_of_uniq[order] = np.arange(len(order))
        vox_rank = rank_of_uniq[inv]  # per-point voxel slot
        keep_vox = vox_rank < max_v
        num_v = min(len(uniq), max_v)
        voxels = np.zeros((num_v, max_ppv, pts.shape[1]), pts.dtype)
        coords = np.zeros((num_v, 3), np.int32)
        sel_first = first_idx[order[:num_v]]
        coords[:, 0] = idx3[sel_first, 2]
        coords[:, 1] = idx3[sel_first, 1]
        coords[:, 2] = idx3[sel_first, 0]
        # vectorized per-voxel fill: stable sort groups points by voxel
        # while preserving point order; slot = rank within the group
        pts_sel = pts_in[keep_vox]
        v_ids = vox_rank[keep_vox]
        order_pts = np.argsort(v_ids, kind="stable")
        v_sorted = v_ids[order_pts]
        slot = np.arange(len(v_sorted)) - np.searchsorted(v_sorted, v_sorted)
        take = slot < max_ppv
        voxels[v_sorted[take], slot[take]] = pts_sel[order_pts][take]
        num_points = np.minimum(
            np.bincount(v_ids, minlength=num_v), max_ppv).astype(np.int32)
        if not data_dict.get("use_lead_xyz", True):
            voxels = voxels[..., 3:]
        data_dict["voxels"] = voxels
        data_dict["voxel_coords"] = coords
        data_dict["voxel_num_points"] = num_points
        return data_dict

    def image_normalize(self, data_dict, config):
        """Per-channel mean/std normalization of multi-cam crops
        (data_processor.image_normalize:236-248; torchvision ToTensor
        scales to [0, 1] first). Contract keyed on dtype, not values:
        integer inputs (the loaders' raw uint8 crops) are scaled by 1/255
        like ToTensor; float inputs are assumed already in [0, 1]."""
        imgs = data_dict.get("camera_imgs")
        if imgs is None:
            return data_dict
        mean = np.asarray(config["mean"], np.float32)
        std = np.asarray(config["std"], np.float32)
        imgs = np.asarray(imgs)
        if np.issubdtype(imgs.dtype, np.integer):
            imgs = imgs.astype(np.float32) / 255.0
        else:
            imgs = imgs.astype(np.float32)
        data_dict["camera_imgs"] = (imgs - mean) / std
        return data_dict

    def image_calibrate(self, data_dict, config):
        """Record the resize/crop/flip/rotate post-homography as 4x4
        img_aug_matrix per camera (data_processor.image_calibrate:250-284)."""
        infos = data_dict.get("img_process_infos")
        if infos is None:
            return data_dict
        transforms = []
        for resize, crop, flip, rotate in infos:
            rotation = np.eye(2, dtype=np.float32) * resize
            translation = -np.asarray(crop[:2], np.float32)
            if flip:
                a = np.array([[-1, 0], [0, 1]], np.float32)
                rotation = a @ rotation
                translation = a @ translation + np.array(
                    [crop[2] - crop[0], 0], np.float32)
            theta = rotate / 180.0 * np.pi
            a = np.array([[np.cos(theta), np.sin(theta)],
                          [-np.sin(theta), np.cos(theta)]], np.float32)
            b = np.array([crop[2] - crop[0], crop[3] - crop[1]],
                         np.float32) / 2
            b = a @ (-b) + b
            rotation = a @ rotation
            translation = a @ translation + b
            tf = np.eye(4, dtype=np.float32)
            tf[:2, :2] = rotation
            tf[:2, 3] = translation
            transforms.append(tf)
        data_dict["img_aug_matrix"] = np.stack(transforms)
        return data_dict

    def downsample_depth_map(self, data_dict, config):
        """Local-mean downscale of the gt depth map
        (data_processor.downsample_depth_map:225-234; skimage
        downscale_local_mean as a numpy block mean with edge padding)."""
        d = int(config["DOWNSAMPLE_FACTOR"])
        depth = data_dict.get("depth_maps")
        if depth is None or d <= 1:
            return data_dict
        h, w = depth.shape
        ph, pw = (-h) % d, (-w) % d
        if ph or pw:  # skimage pads with zeros (cval=0)
            depth = np.pad(depth, ((0, ph), (0, pw)))
        hh, ww = depth.shape
        data_dict["depth_maps"] = depth.reshape(
            hh // d, d, ww // d, d).mean(axis=(1, 3))
        return data_dict

    def shuffle_points(self, data_dict, config):
        if config["SHUFFLE_ENABLED"][self.mode]:
            pts = data_dict["points"]
            idx = np.random.permutation(pts.shape[0])
            data_dict["points"] = pts[idx]
        return data_dict

    def forward(self, data_dict):
        for fn, cfg in self.steps:
            data_dict = fn(data_dict, cfg)
        return data_dict
