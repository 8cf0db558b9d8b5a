"""Official TJ4DRadSet evaluation.

A copy of ``hgsfusion_tpu/eval/tj4d_eval.py``. Its AP40 is its own
(``tj4d_map``: all 41 recall samples over 40), not ``kitti_ap.get_map_r40``.

Reference: pcdet/datasets/kitti/tj4d_utils.py (clean_data:191-275 — range
based difficulty: <=50 m easy, <=70 m moderate, all hard, cumulative;
tj4d_eval:846-994 — forced class order Ped, Cyc, Car, Truck; AP_R40 at two
IoU tiers 0.5 / 0.25; the Overall mAP mixes tiers: Ped/Cyc @0.25 and
Car/Truck @0.5).
"""
from __future__ import annotations

import numpy as np

from .kitti_ap import eval_class

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Truck"]
EVAL_ORDER = ["Pedestrian", "Cyclist", "Car", "Truck"]
DIFFICULTY_RANGES = (50.0, 70.0)

# min_overlaps[tier, metric, class]: tier 0 = 0.5, tier 1 = 0.25 for all
MIN_OVERLAPS = np.stack(
    [np.full((3, 4), 0.5), np.full((3, 4), 0.25)], axis=0
)


def _range_difficulty(loc):
    r = float(np.linalg.norm(loc))
    if 0 < r <= DIFFICULTY_RANGES[0]:
        return 0
    if DIFFICULTY_RANGES[0] < r <= DIFFICULTY_RANGES[1]:
        return 1
    return 2


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    cls_name = CLASS_NAMES[current_class].lower()
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        name = gt_anno["name"][i].lower()
        valid_class = 1 if name == cls_name else -1
        base_diff = gt_anno.get("difficulty", None)
        base = base_diff[i] if base_diff is not None else 0
        diff = _range_difficulty(gt_anno["location"][i]) if base >= 0 else -1
        ignore = diff > difficulty or diff == -1
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
        valid_class = 1 if dt_anno["name"][i].lower() == cls_name else -1
        ignored_dt.append(0 if valid_class == 1 else -1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def tj4d_official_eval(gt_annos, dt_annos, class_names=None):
    """Returns (pretty string, result dict) in the reference's key schema."""
    current_classes = [CLASS_NAMES.index(c) for c in EVAL_ORDER]
    difficulties = [0, 1, 2]
    difficulty_names = ["easy", "moderate", "hard"]

    def tj4d_map(prec):
        """TJ4D's AP40 quirk (tj4d_utils.get_mAP:775-779): sums ALL 41
        recall samples including i=0 (prec at recall 0) over /40 —
        unlike the VoD/KITTI R40 which starts at i=1. Parity-tested
        against the vendored tj4d_utils."""
        return sum(prec[..., i] for i in range(prec.shape[-1])) / 40 * 100

    maps = {}
    for metric, mname in ((0, "2D"), (1, "BEV"), (2, "3D")):
        ret = eval_class(
            gt_annos, dt_annos, clean_data, current_classes, difficulties,
            metric, MIN_OVERLAPS[:, :, current_classes],
        )
        maps[mname] = tj4d_map(ret["precision"])  # (cls, diff, tier)

    result_dict = {}
    lines = []
    for j, ci in enumerate(current_classes):
        cname = CLASS_NAMES[ci]
        for tier in range(MIN_OVERLAPS.shape[0]):
            ov = MIN_OVERLAPS[tier, 0, ci]
            lines.append(f"{cname} AP40@{ov:.2f}:")
            for mname in ("2D", "BEV", "3D"):
                vals = maps[mname][j, :, tier]
                lines.append(
                    f"  {mname:3s} AP: {vals[0]:.4f}, {vals[1]:.4f}, {vals[2]:.4f}"
                )
            postfix = "strict" if tier == 0 else "loose"
            for idx, dname in enumerate(difficulty_names):
                for mname in ("2D", "BEV", "3D"):
                    result_dict[f"KITTI/{cname}_{mname}_{dname}_{postfix}"] = float(
                        maps[mname][j, idx, tier]
                    )

    # Overall mAP: Ped/Cyc at the loose tier (0.25), Car/Truck strict (0.5)
    # (tj4d_eval:962-973)
    lines.append("\nOverall AP40@easy, moderate, hard:")
    for mname in ("2D", "BEV", "3D"):
        mixed = np.concatenate(
            [maps[mname][:2, :, 1], maps[mname][2:4, :, 0]]
        ).mean(axis=0)
        lines.append(f"  {mname:3s} AP: {mixed[0]:.4f}, {mixed[1]:.4f}, {mixed[2]:.4f}")
        for idx, dname in enumerate(difficulty_names):
            result_dict[f"KITTI/Overall_{mname}_{dname}"] = float(mixed[idx])
    return "\n".join(lines), result_dict
