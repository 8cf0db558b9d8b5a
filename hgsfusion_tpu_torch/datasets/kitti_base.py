"""Shared KITTI-format dataset machinery: labels, infos, frames and the
prediction writer (counterpart of ``hgsfusion_tpu/datasets/kitti_base.py``),
numpy. The dataset config is a plain dict.

Reference: pcdet/datasets/kitti/vod_dataset.py (get_label / get_calib /
get_infos / generate_prediction_dicts) and pcdet/utils/object3d_kitti.py.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..ops.points_in_boxes import points_in_boxes
from ..utils import box_utils
from ..utils.calibration import Calibration, calib_to_matricies
from . import image_io
from .dataset import DatasetTemplate


class Object3d:
    """One KITTI label line: type trunc occl alpha bbox4 h w l x y z ry."""

    def __init__(self, line: str):
        parts = line.strip().split(" ")
        self.cls_type = parts[0]
        self.truncation = float(parts[1])
        self.occlusion = float(parts[2])
        self.alpha = float(parts[3])
        self.box2d = np.array([float(x) for x in parts[4:8]], np.float32)
        self.h, self.w, self.l = (float(parts[8]), float(parts[9]), float(parts[10]))
        self.loc = np.array([float(x) for x in parts[11:14]], np.float32)
        self.ry = float(parts[14])
        self.score = float(parts[15]) if len(parts) > 15 else -1.0
        self.dis_to_cam = float(np.linalg.norm(self.loc))
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self) -> int:
        """KITTI difficulty: 0 easy / 1 moderate / 2 hard / -1 unknown."""
        height = float(self.box2d[3] - self.box2d[1])
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 2
        return -1


def read_label(label_file) -> list:
    with open(label_file) as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    return [Object3d(ln) for ln in lines]


class KittiFormatDataset(DatasetTemplate):
    """Base of VoD: the KITTI directory layout with radar .bin clouds."""

    NUM_POINT_FEATURES = 7  # raw radar channels in the .bin files
    IMAGE_EXT = ".jpg"

    def __init__(self, dataset_cfg, class_names, training=False, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        self.root_split_path = self.root_path / ("training" if self.split != "test"
                                                 else "testing")
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_id_list = ([x.strip() for x in open(split_file).readlines()]
                               if split_file.exists() else [])
        self.use_virtual_points = dataset_cfg.get("USE_VIRTUAL_POINTS", False)
        # the reference's default prefix: training/mask/<idx>.pkl.npy
        self.virtual_prefix = dataset_cfg.get("VIRTUAL_POINT_PREFIX", "mask")
        self.infos = []
        self.load_infos()

    # -- raw sample accessors ------------------------------------------------
    def get_lidar(self, idx):
        f = self.root_split_path / "velodyne" / f"{idx}.bin"
        return np.fromfile(str(f), dtype=np.float32).reshape(-1, self.NUM_POINT_FEATURES)

    def get_virtual_points(self, idx):
        """RHGM output: (virtual_points (N, D), real_points (M, D)) from an
        np.save'd dict."""
        f = self.root_split_path / self.virtual_prefix / f"{idx}.pkl.npy"
        data = np.load(str(f), allow_pickle=True).item()
        return data["virtual_points"], data["real_points"]

    def image_path(self, idx) -> Path:
        return self.root_split_path / "image_2" / f"{idx}{self.IMAGE_EXT}"

    def get_image(self, idx):
        """Raw uint8 pixels: the model scales them on the device."""
        return np.asarray(image_io.read_image(self.image_path(idx)), dtype=np.uint8)

    def get_depth_map(self, idx):
        """(H, W) float32 depth map from depth_2/<idx>.png at 1/256 m."""
        depth = image_io.read_image(self.root_split_path / "depth_2" / f"{idx}.png")
        return np.asarray(depth, dtype=np.float32) / 256.0

    def get_image_shape(self, idx):
        return image_io.image_shape(self.image_path(idx))

    def get_label(self, idx):
        return read_label(self.root_split_path / "label_2" / f"{idx}.txt")

    def get_calib(self, idx) -> Calibration:
        return Calibration(self.root_split_path / "calib" / f"{idx}.txt")

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        """Points whose projection lies inside the image."""
        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        flag = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
                & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]))
        return flag & (pts_depth >= 0)

    # -- info files ------------------------------------------------------------
    def load_infos(self):
        for p in self.dataset_cfg["INFO_PATH"][self.mode]:
            path = self.root_path / p
            if path.exists():
                with open(path, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if self.logger is not None:
            self.logger.info(f"Loaded {len(self.infos)} {self.split} samples for "
                             f"{type(self).__name__}")

    def build_frame_info(self, sample_idx, has_label=True, count_inside_pts=True):
        """One info dict (vod_dataset.get_infos content)."""
        info = {
            "point_cloud": {"num_features": self.NUM_POINT_FEATURES, "lidar_idx": sample_idx},
            "image": {"image_idx": sample_idx,
                      "image_shape": self.get_image_shape(sample_idx)},
        }
        calib = self.get_calib(sample_idx)
        P2 = np.vstack([calib.P2, np.array([0, 0, 0, 1], np.float32)])
        R0_4x4 = np.eye(4, dtype=np.float32)
        R0_4x4[:3, :3] = calib.R0
        V2C_4x4 = np.vstack([calib.V2C, np.array([0, 0, 0, 1], np.float32)])
        info["calib"] = {"P2": P2, "R0_rect": R0_4x4, "Tr_velo_to_cam": V2C_4x4}
        if not has_label:
            return info
        obj_list = self.get_label(sample_idx)
        annos = {
            "name": np.array([o.cls_type for o in obj_list]),
            "truncated": np.array([o.truncation for o in obj_list]),
            "occluded": np.array([o.occlusion for o in obj_list]),
            "alpha": np.array([o.alpha for o in obj_list]),
            "bbox": (np.stack([o.box2d for o in obj_list])
                     if obj_list else np.zeros((0, 4), np.float32)),
            "dimensions": (np.array([[o.l, o.h, o.w] for o in obj_list], np.float32)
                           if obj_list else np.zeros((0, 3), np.float32)),
            "location": (np.stack([o.loc for o in obj_list])
                         if obj_list else np.zeros((0, 3), np.float32)),
            "rotation_y": np.array([o.ry for o in obj_list], np.float32),
            "score": np.array([o.score for o in obj_list], np.float32),
            "difficulty": np.array([o.level for o in obj_list], np.int32),
        }
        num_objects = sum(1 for o in obj_list if o.cls_type != "DontCare")
        annos["index"] = np.array(
            list(range(num_objects)) + [-1] * (len(obj_list) - num_objects), np.int32)
        loc = annos["location"][:num_objects]
        dims = annos["dimensions"][:num_objects]
        rots = annos["rotation_y"][:num_objects]
        if num_objects > 0:
            cam_boxes = np.concatenate([loc, dims, rots[..., None]], axis=1)
            annos["gt_boxes_lidar"] = box_utils.boxes3d_kitti_camera_to_lidar(cam_boxes, calib)
        else:
            annos["gt_boxes_lidar"] = np.zeros((0, 7), np.float32)
        if count_inside_pts and num_objects > 0:
            points = self.get_lidar(sample_idx)
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            fov = self.get_fov_flag(pts_rect, info["image"]["image_shape"], calib)
            inside = np.asarray(
                points_in_boxes(points[fov, 0:3], annos["gt_boxes_lidar"])).sum(axis=1)
            annos["num_points_in_gt"] = np.concatenate(
                [inside, -np.ones(len(obj_list) - num_objects)]).astype(np.int32)
        info["annos"] = annos
        return info

    def create_infos(self, splits=("train", "val"), save=True):
        """Write kitti_infos_{split}.pkl for each split; returns their paths."""
        out_files = []
        for split in splits:
            split_file = self.root_path / "ImageSets" / f"{split}.txt"
            ids = [x.strip() for x in open(split_file).readlines()]
            old_split = self.root_split_path
            self.root_split_path = self.root_path / ("training" if split != "test"
                                                     else "testing")
            infos = [self.build_frame_info(i, has_label=(split != "test")) for i in ids]
            self.root_split_path = old_split
            if save:
                out = self.root_path / f"kitti_infos_{split}.pkl"
                with open(out, "wb") as f:
                    pickle.dump(infos, f)
                out_files.append(out)
        return out_files

    # -- __getitem__ -----------------------------------------------------------
    def load_merged_points(self, sample_idx):
        """Raw radar + RHGM virtual/foreground points with indicator flags:
        (idf1, idf2) = (1, 1) raw real | (0, 0) in-gt-box real | (0, 1) virtual."""
        if not self.use_virtual_points:
            return self.get_lidar(sample_idx)
        virtual, gt_real = self.get_virtual_points(sample_idx)
        real = self.get_lidar(sample_idx)
        d = virtual.shape[1]
        if len(gt_real) == 0:
            pts = np.ones((real.shape[0], d + 2), np.float32)
            pts[:, : self.NUM_POINT_FEATURES] = real
            return pts
        n_total = len(real) + len(gt_real) + len(virtual)
        pts = np.ones((n_total, d + 2), np.float32)
        pts[: len(real), : self.NUM_POINT_FEATURES] = real
        pts[len(real):, :-2] = np.concatenate([gt_real, virtual])
        pts[len(real):, -2] = 0.0
        pts[len(real):, -1] = 0.0
        if len(virtual):
            pts[-len(virtual):, -1] = 1.0
        return pts

    def compose_input_dict(self, index):
        """One frame's raw inputs (vod_dataset.__getitem__ body)."""
        info = self.infos[index]
        sample_idx = info["point_cloud"]["lidar_idx"]
        img_shape = info["image"]["image_shape"]
        calib = self.get_calib(sample_idx)
        get_item_list = self.dataset_cfg.get("GET_ITEM_LIST", ["points"])

        input_dict = {"frame_id": sample_idx, "calib": calib,
                      "image_shape": np.asarray(img_shape, np.int32)}
        if "annos" in info:
            annos = info["annos"]
            keep = annos["name"] != "DontCare"
            loc = annos["location"][keep]
            dims = annos["dimensions"][keep]
            rots = annos["rotation_y"][keep]
            cam_boxes = np.concatenate([loc, dims, rots[..., None]], axis=1).astype(np.float32)
            input_dict["gt_names"] = annos["name"][keep]
            input_dict["gt_boxes"] = box_utils.boxes3d_kitti_camera_to_lidar(cam_boxes, calib)
            if "gt_boxes2d" in get_item_list:
                input_dict["gt_boxes2d"] = annos["bbox"][keep]

        if "points" in get_item_list:
            points = self.load_merged_points(sample_idx)
            if self.dataset_cfg.get("FOV_POINTS_ONLY", False):
                pts_rect = calib.lidar_to_rect(points[:, 0:3])
                points = points[self.get_fov_flag(pts_rect, img_shape, calib)]
            input_dict["points"] = points

        if "images" in get_item_list:
            input_dict["images"] = self.get_image(sample_idx)

        if "depth_maps" in get_item_list:
            input_dict["depth_maps"] = self.get_depth_map(sample_idx)

        if "calib_matricies" in get_item_list:
            v2r, p2 = calib_to_matricies(calib)
            input_dict["trans_lidar_to_cam"] = v2r.astype(np.float32)
            input_dict["trans_cam_to_img"] = p2.astype(np.float32)
        return input_dict

    def __len__(self):
        return self.merged_len(len(self.infos))

    def __getitem__(self, index):
        return self.getitem_with_resample(
            index, lambda i: self.prepare_data(self.compose_input_dict(i)), len(self.infos))

    # -- prediction output ---------------------------------------------------
    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Decoded lidar predictions -> KITTI-format annos, and one
        ``<frame_id>.txt`` each under ``output_path`` when it is given."""
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            frame_id = batch_dict["frame_id"][index]
            calib = batch_dict["calib"][index]
            image_shape = np.asarray(batch_dict["image_shape"][index]).reshape(-1)

            pred_boxes = np.asarray(box_dict["pred_boxes"], np.float32)
            pred_scores = np.asarray(box_dict["pred_scores"], np.float32)
            pred_labels = np.asarray(box_dict["pred_labels"], np.int32)

            n = pred_boxes.shape[0]
            single = {
                "name": np.zeros(n, dtype="<U16"), "truncated": np.zeros(n),
                "occluded": np.zeros(n), "alpha": np.zeros(n),
                "bbox": np.zeros([n, 4]), "dimensions": np.zeros([n, 3]),
                "location": np.zeros([n, 3]), "rotation_y": np.zeros(n),
                "score": np.zeros(n), "boxes_lidar": np.zeros([n, 7]),
                "frame_id": frame_id,
            }
            if n > 0:
                cam_boxes = box_utils.boxes3d_lidar_to_kitti_camera(pred_boxes, calib)
                boxes2d = box_utils.boxes3d_kitti_camera_to_imageboxes(
                    cam_boxes, calib, image_shape=image_shape)
                single["name"] = np.array(class_names)[pred_labels - 1]
                single["alpha"] = (-np.arctan2(-pred_boxes[:, 1], pred_boxes[:, 0])
                                   + cam_boxes[:, 6])
                single["bbox"] = boxes2d
                single["dimensions"] = cam_boxes[:, 3:6]
                single["location"] = cam_boxes[:, 0:3]
                single["rotation_y"] = cam_boxes[:, 6]
                single["score"] = pred_scores
                single["boxes_lidar"] = pred_boxes
            annos.append(single)

            if output_path is not None:
                with open(Path(output_path) / f"{frame_id}.txt", "w") as f:
                    for k in range(n):
                        b = single["bbox"][k]
                        d = single["dimensions"][k]  # (l, h, w) camera order
                        loc = single["location"][k]
                        print("%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                              "%.4f %.4f %.4f %.4f %.4f"
                              % (single["name"][k], single["alpha"][k],
                                 b[0], b[1], b[2], b[3], d[1], d[2], d[0],
                                 loc[0], loc[1], loc[2],
                                 single["rotation_y"][k], single["score"][k]),
                              file=f)
        return annos
