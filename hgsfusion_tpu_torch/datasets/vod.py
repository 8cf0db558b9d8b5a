"""View-of-Delft 4D-radar dataset (counterpart of
``hgsfusion_tpu/datasets/vod.py``).

Reference: pcdet/datasets/kitti/vod_dataset.py (7-channel radar .bin: x, y,
z, rcs, v_r, v_r_comp, time; jpg images; the VoD entire-area and
driving-corridor evaluation).
"""
from __future__ import annotations

from ..eval.vod_eval import vod_official_eval
from .kitti_base import KittiFormatDataset


class VODDataset(KittiFormatDataset):
    NUM_POINT_FEATURES = 7
    IMAGE_EXT = ".jpg"

    def evaluation(self, det_annos, class_names, **kwargs):
        """Official VoD protocol: 11-point AP (R40 under the *_R40 keys) at
        IoU .5/.25/.25, over the entire annotated area and the driving
        corridor (camera coords |x| < 4 m, z < 25 m). Returns (table, dict)."""
        gt_annos = [info["annos"] for info in self.infos]
        return vod_official_eval(gt_annos, det_annos, class_names)
