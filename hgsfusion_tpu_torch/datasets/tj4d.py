"""TJ4DRadSet 4D-radar dataset (counterpart of
``hgsfusion_tpu/datasets/tj4d.py``).

Reference: pcdet/datasets/kitti/tj4d_dataset.py (8-channel radar .bin: x, y,
z, V_r, Range, Power, Alpha, Beta; png images; AP_R40 at IoU .5/.25 with the
Overall mAP mixing tiers, Ped/Cyc @0.25 and Car/Truck @0.5, and per-weather
splits, tj4d_dataset.py:477-516 / tj4d_utils.py:846-994).
"""
from __future__ import annotations

from ..eval.tj4d_eval import tj4d_official_eval
from .kitti_base import KittiFormatDataset

# per-weather sequence groups (tj4d_dataset.py:494-499)
WEATHER_FILTER = {
    "dark": [0, 1],
    "standard": [5, 10, 20, 23, 37, 41],
    "shiny": [30, 31, 34],
    "all_weather": [0, 1, 5, 10, 20, 23, 37, 41, 30, 31, 34],
}


class TJ4DDataset(KittiFormatDataset):
    NUM_POINT_FEATURES = 8
    IMAGE_EXT = ".png"

    def evaluation(self, det_annos, class_names, **kwargs):
        """Official TJ4D protocol over every frame; with
        ``FILTER_BY_WEATHER`` again over each weather group (a frame's
        sequence is the first two digits of its id), under
        ``<weather>/<key>``. Returns (table, dict)."""
        gt_annos = [info["annos"] for info in self.infos]
        result_str, result_dict = tj4d_official_eval(gt_annos, det_annos, class_names)
        if self.dataset_cfg.get("FILTER_BY_WEATHER", False):
            seqs = [int(info["image"]["image_idx"][:2]) for info in self.infos]
            for weather, group in WEATHER_FILTER.items():
                keep = [i for i, s in enumerate(seqs) if s in group]
                if not keep:
                    continue
                s, d = tj4d_official_eval([gt_annos[i] for i in keep],
                                          [det_annos[i] for i in keep], class_names)
                result_str += f"\n== weather: {weather} ==\n{s}"
                for k, v in d.items():
                    result_dict[f"{weather}/{k}"] = v
        return result_str, result_dict
