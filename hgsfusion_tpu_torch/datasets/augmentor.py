"""Training-time augmentations (counterpart of
``hgsfusion_tpu/datasets/augmentor.py``), numpy, on the host.

The ported ops are the four that both HGSFusion configs list: the world flip,
the image flip that follows it, the world rotation and the world scaling.
Every op draws from the global ``np.random`` stream in the JAX package's
order, so the same seed gives the same frames. Any other op that a config
names and does not disable raises at construction. The boxes are the
7-column lidar boxes (x, y, z, dx, dy, dz, heading); the class column is
appended after the augmentor (``DatasetTemplate.prepare_data``).

Reference: pcdet/datasets/augmentor/data_augmentor.py and augmentor_utils.py.
"""
from __future__ import annotations

import numpy as np

from ..utils.box_utils import rotate_points_along_z_np

PORTED = ("random_world_flip", "random_image_flip_fusion", "random_world_rotation",
          "random_world_scaling")


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        disable = set(augmentor_configs.get("DISABLE_AUG_LIST", []))
        self.queue = []
        for cfg in augmentor_configs["AUG_CONFIG_LIST"]:
            name = cfg["NAME"]
            if name in disable:
                continue
            if name not in PORTED:
                raise NotImplementedError(
                    f"DATA_AUGMENTOR: {name} is not ported (ROADMAP.md queue 1 item 2); "
                    f"list it in DISABLE_AUG_LIST or use {', '.join(PORTED)}")
            self.queue.append((getattr(self, name), cfg))

    # -- individual augmentations -------------------------------------------
    @staticmethod
    def _flip_boxes(boxes, axis):
        """In-place flip of (N, 7) boxes: across the x axis negates y and the
        heading, across the y axis negates x and maps the heading to
        -(heading + pi)."""
        if axis == "x":
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
        else:
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = -(boxes[:, 6] + np.pi)

    def random_world_flip(self, data_dict, config):
        for axis in config["ALONG_AXIS_LIST"]:
            if axis not in ("x", "y"):
                raise ValueError(f"random_world_flip: axis {axis!r}")
            enable = bool(np.random.choice([False, True]))
            if enable:
                self._flip_boxes(data_dict["gt_boxes"], axis)
                col = 1 if axis == "x" else 0
                data_dict["points"][:, col] = -data_dict["points"][:, col]
            data_dict[f"flip_{axis}"] = enable
        return data_dict

    def random_world_rotation(self, data_dict, config):
        rot_range = config["WORLD_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        noise_rot = np.random.uniform(rot_range[0], rot_range[1])
        angle = np.array([noise_rot])
        data_dict["points"] = rotate_points_along_z_np(data_dict["points"][None], angle)[0]
        gt = data_dict["gt_boxes"]
        gt[:, 0:3] = rotate_points_along_z_np(gt[None, :, 0:3], angle)[0]
        gt[:, 6] += noise_rot
        data_dict["noise_rot"] = noise_rot
        return data_dict

    def random_world_scaling(self, data_dict, config):
        lo, hi = config["WORLD_SCALE_RANGE"]
        if hi - lo < 1e-3:
            return data_dict
        scale = np.random.uniform(lo, hi)
        data_dict["points"][:, :3] *= scale
        data_dict["gt_boxes"][:, :6] *= scale
        data_dict["noise_scale"] = scale
        return data_dict

    def _flip_image_with_boxes(self, data_dict):
        """Horizontal image flip: each box centre is flipped in image space
        and lifted back through the calibration, so camera and lidar stay
        aligned; the heading is negated and the 2-D boxes mirrored."""
        image = data_dict["images"]
        calib = data_dict["calib"]
        gt = data_dict["gt_boxes"]
        data_dict["images"] = np.ascontiguousarray(np.fliplr(image))
        w = image.shape[1]
        img_pts, img_depth = calib.lidar_to_img(gt[:, :3])
        img_pts[:, 0] = w - img_pts[:, 0]
        pts_rect = calib.img_to_rect(u=img_pts[:, 0], v=img_pts[:, 1], depth_rect=img_depth)
        gt[:, :3] = calib.rect_to_lidar(pts_rect)
        gt[:, 6] = -gt[:, 6]
        if data_dict.get("gt_boxes2d", None) is not None and len(data_dict["gt_boxes2d"]):
            b2d = data_dict["gt_boxes2d"]
            b2d[:, [0, 2]] = w - b2d[:, [2, 0]]
        for key in ("foreground", "depth_maps"):
            if key in data_dict:
                data_dict[key] = np.ascontiguousarray(np.fliplr(data_dict[key]))
        return data_dict

    def random_image_flip_fusion(self, data_dict, config):
        """Flip the image iff the world was flipped along x."""
        if not data_dict.get("flip_x", False):
            return data_dict
        return self._flip_image_with_boxes(data_dict)

    def forward(self, data_dict):
        """Apply the queue, wrap each heading into [-pi, pi), then keep the
        boxes of ``gt_boxes_mask`` (their names and 2-D boxes too)."""
        if "roi_boxes" in data_dict or data_dict["gt_boxes"].shape[1] > 7:
            raise NotImplementedError(
                "the port's augmentor takes 7-column lidar boxes without roi_boxes "
                "(velocity and proposal boxes are ROADMAP.md queue 1 item 9)")
        for fn, cfg in self.queue:
            data_dict = fn(data_dict, cfg)
        gt = data_dict["gt_boxes"]
        if len(gt):
            gt[:, 6] = gt[:, 6] - np.floor(gt[:, 6] / (2 * np.pi) + 0.5) * 2 * np.pi
        data_dict.pop("road_plane", None)
        if "gt_boxes_mask" in data_dict:
            mask = data_dict.pop("gt_boxes_mask")
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            data_dict["gt_names"] = data_dict["gt_names"][mask]
            if data_dict.get("gt_boxes2d", None) is not None:
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][mask]
        return data_dict
