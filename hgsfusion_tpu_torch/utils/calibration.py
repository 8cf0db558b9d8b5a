"""KITTI-format calibration (numpy, data-layer only); a copy of
``hgsfusion_tpu/utils/calibration.py``.

Reference: pcdet/utils/calibration_kitti.py:4-125 and
pcdet/datasets/kitti/kitti_utils.py:52-66 (calib_to_matricies).
"""
from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()
    obj = lines[2].strip().split(" ")[1:]
    P2 = np.array(obj, dtype=np.float32)
    obj = lines[3].strip().split(" ")[1:]
    P3 = np.array(obj, dtype=np.float32)
    obj = lines[4].strip().split(" ")[1:]
    R0 = np.array(obj, dtype=np.float32)
    obj = lines[5].strip().split(" ")[1:]
    Tr_velo_to_cam = np.array(obj, dtype=np.float32)
    return {
        "P2": P2.reshape(3, 4),
        "P3": P3.reshape(3, 4),
        "R0": R0.reshape(3, 3),
        "Tr_velo2cam": Tr_velo_to_cam.reshape(3, 4),
    }


class Calibration:
    """KITTI calibration with lidar<->rect<->image transforms."""

    def __init__(self, calib_file):
        calib = calib_file if isinstance(calib_file, dict) else get_calib_from_file(calib_file)
        self.P2 = calib["P2"].astype(np.float32)
        self.R0 = calib["R0"].astype(np.float32)
        self.V2C = calib["Tr_velo2cam"].astype(np.float32)

        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def cart_to_hom(pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def _rect_to_lidar_mat(self):
        R0_ext = np.eye(4, dtype=np.float32)
        R0_ext[:3, :3] = self.R0
        V2C_ext = np.eye(4, dtype=np.float32)
        V2C_ext[:3, :4] = self.V2C
        return np.linalg.inv(R0_ext @ V2C_ext)

    def rect_to_lidar(self, pts_rect):
        pts_hom = self.cart_to_hom(pts_rect.astype(np.float32))
        return (pts_hom @ self._rect_to_lidar_mat().T)[:, 0:3]

    def lidar_to_rect(self, pts_lidar):
        pts_hom = self.cart_to_hom(pts_lidar.astype(np.float32))
        return pts_hom @ (self.V2C.T @ self.R0.T)

    def rect_to_img(self, pts_rect):
        pts_hom = self.cart_to_hom(pts_rect.astype(np.float32))
        pts_2d_hom = pts_hom @ self.P2.T
        pts_img = (pts_2d_hom[:, 0:2].T / pts_hom[:, 2]).T
        pts_depth = pts_2d_hom[:, 2] - self.P2.T[3, 2]
        return pts_img, pts_depth

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.concatenate(
            (x.reshape(-1, 1), y.reshape(-1, 1), depth_rect.reshape(-1, 1)), axis=1
        )


def calib_to_matricies(calib: Calibration):
    """Calibration -> (lidar->rect 4x4, projection 3x4). kitti_utils.py:52-66."""
    V2C = np.vstack((calib.V2C, np.array([0, 0, 0, 1], dtype=np.float32)))
    R0 = np.hstack((calib.R0, np.zeros((3, 1), dtype=np.float32)))
    R0 = np.vstack((R0, np.array([0, 0, 0, 1], dtype=np.float32)))
    V2R = R0 @ V2C
    return V2R, calib.P2
