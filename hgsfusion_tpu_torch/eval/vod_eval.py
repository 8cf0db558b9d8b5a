"""Official View-of-Delft evaluation: entire annotated area + driving corridor.

A copy of ``hgsfusion_tpu/eval/vod_eval.py``.

Reference: pcdet/utils/vod_utils.py (clean_data:30-115 incl. the roi_clean
driving-corridor filter |x| < 4 m, z < 25 m in camera coords;
get_official_eval_result:681-762 with the VoD min-overlap table — BEV/3D
IoU 0.5 Car / 0.25 Ped / 0.25 Cyc at tier index 1 — and custom_method 0
(entire area) / 3 (ROI)).
"""
from __future__ import annotations

import numpy as np

from .kitti_ap import eval_class, get_map_r11, get_map_r40

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist"]
MIN_INSTANCE_HEIGHT = 40.0
MAX_INSTANCE_OCCLUSION = 4
ROI_LEFT, ROI_RIGHT, ROI_MAX_DISTANCE = -4.0, 4.0, 25.0

# min_overlaps[tier, metric(bbox/bev/3d), class(Car/Ped/Cyc)]
MIN_OVERLAPS = np.array(
    [
        [[0.7, 0.5, 0.5], [0.7, 0.5, 0.5], [0.7, 0.5, 0.5]],  # strict tier
        [[0.7, 0.5, 0.5], [0.5, 0.25, 0.25], [0.5, 0.25, 0.25]],  # official
    ]
)


def make_clean_data(roi_clean: bool):
    def clean_data(gt_anno, dt_anno, current_class, difficulty):
        cls_name = CLASS_NAMES[current_class].lower()
        ignored_gt, ignored_dt, dc_bboxes = [], [], []
        num_valid_gt = 0
        for i in range(len(gt_anno["name"])):
            name = gt_anno["name"][i].lower()
            bbox = gt_anno["bbox"][i]
            height = bbox[3] - bbox[1]
            if name == cls_name:
                valid_class = 1
            elif cls_name == "pedestrian" and name == "person_sitting":
                valid_class = 0
            elif cls_name == "car" and name == "van":
                valid_class = 0
            else:
                valid_class = -1
            ignore = (
                gt_anno["occluded"][i] > MAX_INSTANCE_OCCLUSION
                or height <= MIN_INSTANCE_HEIGHT
            )
            if roi_clean:
                x, y, z = gt_anno["location"][i]
                if x < ROI_LEFT or x > ROI_RIGHT or z > ROI_MAX_DISTANCE:
                    ignore = True
            if valid_class == 1 and not ignore:
                ignored_gt.append(0)
                num_valid_gt += 1
            elif valid_class == 0 or (ignore and valid_class == 1):
                ignored_gt.append(1)
            else:
                ignored_gt.append(-1)
            if gt_anno["name"][i] == "DontCare":
                dc_bboxes.append(gt_anno["bbox"][i])
        for i in range(len(dt_anno["name"])):
            x, y, z = dt_anno["location"][i]
            valid_class = 1 if dt_anno["name"][i].lower() == cls_name else -1
            height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
            if height < MIN_INSTANCE_HEIGHT:
                ignored_dt.append(1)
            elif roi_clean and (x < ROI_LEFT or x > ROI_RIGHT or z > ROI_MAX_DISTANCE):
                ignored_dt.append(1)
            elif valid_class == 1:
                ignored_dt.append(0)
            else:
                ignored_dt.append(-1)
        return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes

    return clean_data


def _eval_region(gt_annos, dt_annos, current_classes, roi: bool,
                 compute_aos: bool = True):
    clean = make_clean_data(roi_clean=roi)
    out = {}
    for metric, name in ((0, "bbox"), (1, "bev"), (2, "3d")):
        ret = eval_class(
            gt_annos, dt_annos, clean, current_classes, [0], metric,
            MIN_OVERLAPS[:, :, current_classes],
            compute_aos=compute_aos and metric == 0,
        )
        out[name] = {
            "R40": get_map_r40(ret["precision"]),
            "R11": get_map_r11(ret["precision"]),
        }
        if metric == 0 and compute_aos:
            out["aos"] = {
                "R40": get_map_r40(ret["orientation"]),
                "R11": get_map_r11(ret["orientation"]),
            }
    return out


def vod_official_eval(gt_annos, dt_annos, class_names=CLASS_NAMES,
                      compute_aos: bool = True):
    """Both protocol variants. Returns (pretty string, flat result dict).

    Headline `*_all` keys match the reference EXACTLY (parity-tested vs
    the vendored vod_utils in tests/test_reference_parity.py): 11-point
    interpolated AP at the official tier (index 1) — vod_utils.do_eval
    reports get_m_ap (R11) values into the returned dict
    (vod_utils.py:668-682), even though it also computes R40. The R40
    values are exposed alongside under `*_R40` keys.
    """
    current_classes = [CLASS_NAMES.index(c) for c in class_names if c in CLASS_NAMES]
    result_dict = {}
    lines = []
    for roi, region in ((False, "entire_area"), (True, "roi")):
        res = _eval_region(gt_annos, dt_annos, current_classes, roi, compute_aos)
        lines.append(f"==== {region} ====")
        for j, ci in enumerate(current_classes):
            cname = CLASS_NAMES[ci]
            ap3d = res["3d"]["R11"][j, 0, 1]
            apbev = res["bev"]["R11"][j, 0, 1]
            result_dict[f"{region}/{cname}_3d_all"] = float(ap3d)
            result_dict[f"{region}/{cname}_bev_all"] = float(apbev)
            result_dict[f"{region}/{cname}_3d_all_R40"] = float(
                res["3d"]["R40"][j, 0, 1])
            result_dict[f"{region}/{cname}_bev_all_R40"] = float(
                res["bev"]["R40"][j, 0, 1])
            if "aos" in res:
                result_dict[f"{region}/{cname}_aos_all"] = float(
                    res["aos"]["R11"][j, 0, 1]
                )
                result_dict[f"{region}/{cname}_aos_all_R40"] = float(
                    res["aos"]["R40"][j, 0, 1]
                )
            lines.append(f"{cname:12s} 3D AP: {ap3d:6.2f}  BEV AP: {apbev:6.2f}")
        m3d = np.mean([result_dict[f"{region}/{CLASS_NAMES[ci]}_3d_all"]
                       for ci in current_classes])
        mbev = np.mean([result_dict[f"{region}/{CLASS_NAMES[ci]}_bev_all"]
                        for ci in current_classes])
        result_dict[f"{region}/mAP_3d"] = float(m3d)
        result_dict[f"{region}/mAP_bev"] = float(mbev)
        lines.append(f"{'mAP':12s} 3D: {m3d:6.2f}  BEV: {mbev:6.2f}")
    return "\n".join(lines), result_dict
