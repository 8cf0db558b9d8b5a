"""Dataset template: the prepare_data pipeline and static-shape batch
collation (counterpart of ``hgsfusion_tpu/datasets/dataset.py``), numpy.

Every batch has static shapes: points padded to MAX_POINTS with a validity
mask, gt boxes padded to MAX_GT_BOXES, images padded to IMAGE_SIZE. The
dataset config is a plain dict, as ``config.load_config`` returns it.
With ``training=True`` every frame first goes through the data augmentor
(``augmentor.py``), records its flip/rotation/scale as ``lidar_aug_matrix``,
and a frame left with no gt box is replaced by a random other one.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .augmentor import DataAugmentor
from .processor import DataProcessor, PointFeatureEncoder


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(
            root_path if root_path is not None else dataset_cfg["DATA_PATH"])
        if dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.asarray(dataset_cfg["POINT_CLOUD_RANGE"], np.float32)
        self.max_points = int(dataset_cfg.get("MAX_POINTS", 16384))
        self.max_gt_boxes = int(dataset_cfg.get("MAX_GT_BOXES", 64))
        self.image_size = tuple(dataset_cfg.get("IMAGE_SIZE", (516, 1936)))

        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg["POINT_FEATURE_ENCODING"], point_cloud_range=self.point_cloud_range)
        self.data_augmentor = (DataAugmentor(self.root_path, dataset_cfg["DATA_AUGMENTOR"],
                                             class_names, logger) if training else None)
        self.data_processor = DataProcessor(
            dataset_cfg["DATA_PROCESSOR"], point_cloud_range=self.point_cloud_range,
            training=training,
            num_point_features=self.point_feature_encoder.num_point_features)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self._merge_all_iters_to_one_epoch = False
        self.total_epochs = 0

    @property
    def mode(self):
        return "train" if self.training else "test"

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def getitem_with_resample(self, index, get_one, num_infos):
        """Shared __getitem__ skeleton: prepare one sample, redraw a random
        index while a frame comes back empty (training only), then pad to
        static shapes. get_one(index) -> prepared dict or None."""
        if self._merge_all_iters_to_one_epoch:
            index = index % num_infos
        for _ in range(num_infos + 1):
            data = get_one(index)
            if data is not None:
                return self.pad_to_static(data)
            index = np.random.randint(num_infos)
        for i in range(num_infos):
            data = get_one(i)
            if data is not None:
                return self.pad_to_static(data)
        raise RuntimeError("no frame with gt boxes in the dataset")

    def merged_len(self, num_infos):
        """len() under the merge-all-iters-to-one-epoch flag."""
        if self._merge_all_iters_to_one_epoch:
            return num_infos * self.total_epochs
        return num_infos

    # ------------------------------------------------------------------
    @staticmethod
    def set_lidar_aug_matrix(data_dict):
        """Record the composed flip/rot/scale/translate as a 4x4, used to
        undo BEV augmentation in the frustum grid (BEV_AUG). Flips are
        recorded only when 'flip_y' is present."""
        m = np.eye(4, dtype=np.float32)
        if "flip_y" in data_dict:
            if data_dict.get("flip_x", False):
                m[:3, :3] = np.diag([1.0, -1.0, 1.0]).astype(np.float32) @ m[:3, :3]
            if data_dict.get("flip_y", False):
                m[:3, :3] = np.diag([-1.0, 1.0, 1.0]).astype(np.float32) @ m[:3, :3]
        if "noise_rot" in data_dict:
            a = data_dict["noise_rot"]
            rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                           dtype=np.float32)
            m[:3, :3] = rot @ m[:3, :3]
        if "noise_scale" in data_dict:
            m[:3, :3] *= data_dict["noise_scale"]
        if "noise_translate" in data_dict:
            m[:3, 3] = np.asarray(data_dict["noise_translate"], np.float32).reshape(3)
        data_dict["lidar_aug_matrix"] = m
        return data_dict

    def prepare_data(self, data_dict):
        """augment (training) -> aug-matrix -> class filter -> encode ->
        process. A training frame left with no gt box returns None, and the
        caller draws another."""
        if self.training:
            gt_boxes_mask = np.array([n in self.class_names for n in data_dict["gt_names"]],
                                     dtype=bool)
            calib = data_dict.get("calib")
            data_dict = self.data_augmentor.forward({**data_dict, "gt_boxes_mask": gt_boxes_mask})
            if calib is not None:
                data_dict["calib"] = calib
        data_dict.pop("road_plane", None)
        data_dict = self.set_lidar_aug_matrix(data_dict)

        if data_dict.get("gt_boxes", None) is not None:
            selected = [i for i, n in enumerate(data_dict["gt_names"])
                        if n in self.class_names]
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                dtype=np.float32)
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"], gt_classes.reshape(-1, 1)], axis=1
            ).astype(np.float32)
            if data_dict.get("gt_boxes2d", None) is not None:
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][selected]

        if data_dict.get("points", None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict)
        if self.training and len(data_dict.get("gt_boxes", [])) == 0:
            return None
        data_dict.pop("gt_names", None)
        return data_dict

    # ------------------------------------------------------------------
    def pad_to_static(self, data_dict):
        """Pad a prepared sample to the static shapes the model takes.
        Truncation past MAX_POINTS / MAX_GT_BOXES warns once per dataset."""
        out = dict(data_dict)
        pts = data_dict["points"].astype(np.float32)
        n = min(len(pts), self.max_points)
        if len(pts) > self.max_points and not getattr(self, "_warned_point_truncation", False):
            self._warned_point_truncation = True
            (self.logger.warning if self.logger else print)(
                f"pad_to_static: frame has {len(pts)} points but "
                f"DATA_CONFIG.MAX_POINTS={self.max_points}; truncating "
                f"(raise MAX_POINTS to keep the full cloud)")
        points = np.zeros((self.max_points, pts.shape[1]), np.float32)
        points[:n] = pts[:n]
        valid = np.zeros((self.max_points,), bool)
        valid[:n] = True
        out["points"] = points
        out["points_valid"] = valid

        if data_dict.get("gt_boxes", None) is not None:
            gt = data_dict["gt_boxes"]
            m = min(len(gt), self.max_gt_boxes)
            if len(gt) > self.max_gt_boxes and not getattr(self, "_warned_gt_truncation", False):
                self._warned_gt_truncation = True
                (self.logger.warning if self.logger else print)(
                    f"pad_to_static: frame has {len(gt)} gt boxes but "
                    f"DATA_CONFIG.MAX_GT_BOXES={self.max_gt_boxes}; truncating")
            boxes = np.zeros((self.max_gt_boxes, gt.shape[1]), np.float32)
            boxes[:m] = gt[:m]
            out["gt_boxes"] = boxes

        if data_dict.get("gt_boxes2d", None) is not None:
            b2 = np.asarray(data_dict["gt_boxes2d"], np.float32).reshape(-1, 4)
            m = min(len(b2), self.max_gt_boxes)
            boxes2d = np.zeros((self.max_gt_boxes, 4), np.float32)
            boxes2d[:m] = b2[:m]
            out["gt_boxes2d"] = boxes2d

        if data_dict.get("images", None) is not None:
            img = data_dict["images"]
            h, w = self.image_size
            # uint8 images stay uint8 up to the device (preprocess_images
            # scales them there)
            padded = np.zeros((h, w, 3), img.dtype if img.dtype == np.uint8 else np.float32)
            ch, cw = min(img.shape[0], h), min(img.shape[1], w)
            padded[:ch, :cw] = img[:ch, :cw]
            out["images"] = padded

        if data_dict.get("depth_maps", None) is not None:
            dm = np.asarray(data_dict["depth_maps"], np.float32)
            d = max(self.image_size[0] // max(dm.shape[0], 1), 1)
            th, tw = self.image_size[0] // d, self.image_size[1] // d
            padded_dm = np.zeros((th, tw), np.float32)
            ch, cw = min(dm.shape[0], th), min(dm.shape[1], tw)
            padded_dm[:ch, :cw] = dm[:ch, :cw]
            out["depth_maps"] = padded_dm

        if "lidar_aug_matrix" not in out:
            out["lidar_aug_matrix"] = np.eye(4, dtype=np.float32)
        return out

    @staticmethod
    def collate_batch(batch_list):
        """Stack static-shape samples into a batch dict of numpy arrays: a key
        whose per-sample values are same-shape numeric arrays stacks to
        (B, ...); host-side metadata stays a list."""
        meta_keys = {"frame_id", "calib", "metadata", "image_path", "gt_names",
                     "use_lead_xyz"}
        out = {}
        for key in batch_list[0]:
            vals = [s[key] for s in batch_list]
            stackable = key not in meta_keys and all(
                isinstance(v, np.ndarray) and v.dtype != object
                and v.dtype.kind in "biufc" and v.shape == vals[0].shape
                for v in vals)
            out[key] = np.stack(vals, axis=0) if stackable else vals
        out["batch_size"] = len(batch_list)
        return out
