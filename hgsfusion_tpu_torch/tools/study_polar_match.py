"""Box-level comparison of two evaluation runs, and the official AP of each
(counterpart of the JAX package's ``tools/study_polar_match.py``).

    python -m hgsfusion_tpu_torch.tools.study_polar_match --a <gather result.pkl> \\
        --b <polar result.pkl> --infos <kitti_infos_val.pkl> [--dataset vod|tj4d] \\
        [--score_thresh 0.1] [--json out.json]

Compares the ``result.pkl`` annotation lists that ``tools/test.py`` writes,
box for box after NMS, and scores both against the ground truth with the
official protocol (``eval/vod_eval.py`` or ``eval/tj4d_eval.py``). Per
class:

- the detections of each run at the score threshold;
- the matched share at the protocol min-overlap (greedy, score-ordered
  1:1 matching on camera-frame 3-D IoU): matches / max(nA, nB);
- the matched IoUs (mean, median, p10) and |score delta|s (mean, max);
- the unmatched boxes of each side;

and the official AP of each run (every float key) with B - A. ``--json``
writes the same keys as the JAX tool.
"""
from __future__ import annotations

import argparse
import json
import pickle

import numpy as np

from ..eval.kitti_ap import d3_box_overlap
from ..eval.tj4d_eval import tj4d_official_eval
from ..eval.vod_eval import vod_official_eval

# protocol min-overlaps (vod_eval.py's official tier: IoU 0.5 Car, 0.25
# Pedestrian and Cyclist; Truck takes TJ4D's Car threshold)
MIN_OVERLAP = {"Car": 0.5, "Pedestrian": 0.25, "Cyclist": 0.25, "Truck": 0.5}


def _cam_boxes7(anno, idx):
    """(n, 7) camera-frame [x, y, z, l, h, w, ry] rows for kitti_ap's IoU."""
    loc = np.asarray(anno["location"])[idx].reshape(-1, 3)
    dims = np.asarray(anno["dimensions"])[idx].reshape(-1, 3)  # (l, h, w)
    ry = np.asarray(anno["rotation_y"])[idx].reshape(-1, 1)
    return np.concatenate([loc, dims, ry], axis=1).astype(np.float64)


def greedy_match(boxes_a, scores_a, boxes_b, scores_b, min_iou):
    """Score-ordered greedy 1:1 matching on camera 3-D IoU: each box of A,
    best score first, takes the free box of B it overlaps most, at IoU >=
    ``min_iou``. Returns (pairs, ious), pairs a list of (ia, ib)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return [], []
    iou = d3_box_overlap(boxes_a, boxes_b)
    pairs, ious = [], []
    used_b = set()
    for ia in np.argsort(-scores_a):
        cand = [(iou[ia, ib], ib) for ib in np.argsort(-iou[ia])
                if ib not in used_b and iou[ia, ib] >= min_iou]
        if cand:
            best_iou, ib = max(cand)
            used_b.add(ib)
            pairs.append((int(ia), int(ib)))
            ious.append(float(best_iou))
    return pairs, ious


def analyze(annos_a, annos_b, class_names, score_thresh=0.1):
    """Per-class box-level match statistics over all frames."""
    stats = {c: dict(n_a=0, n_b=0, matched=0, ious=[], sdelta=[]) for c in class_names}
    if len(annos_a) != len(annos_b):
        raise ValueError(f"frame count mismatch: {len(annos_a)} vs {len(annos_b)}")
    for fa, fb in zip(annos_a, annos_b):
        for cname in class_names:
            thr = MIN_OVERLAP.get(cname, 0.25)
            sa = np.asarray(fa["score"], np.float64)
            sb = np.asarray(fb["score"], np.float64)
            ia = np.where((np.asarray(fa["name"]) == cname) & (sa >= score_thresh))[0]
            ib = np.where((np.asarray(fb["name"]) == cname) & (sb >= score_thresh))[0]
            st = stats[cname]
            st["n_a"] += len(ia)
            st["n_b"] += len(ib)
            pairs, ious = greedy_match(_cam_boxes7(fa, ia), sa[ia], _cam_boxes7(fb, ib),
                                       sb[ib], thr)
            st["matched"] += len(pairs)
            st["ious"].extend(ious)
            st["sdelta"].extend(abs(float(sa[ia[pa]]) - float(sb[ib[pb]])) for pa, pb in pairs)
    out = {}
    for cname, st in stats.items():
        ious = np.asarray(st["ious"]) if st["ious"] else np.zeros(0)
        sd = np.asarray(st["sdelta"]) if st["sdelta"] else np.zeros(0)
        denom = max(st["n_a"], st["n_b"], 1)
        out[cname] = {
            "n_a": st["n_a"], "n_b": st["n_b"], "matched": st["matched"],
            "match_rate": st["matched"] / denom,
            "unmatched_a": st["n_a"] - st["matched"],
            "unmatched_b": st["n_b"] - st["matched"],
            "iou_mean": float(ious.mean()) if ious.size else None,
            "iou_median": float(np.median(ious)) if ious.size else None,
            "iou_p10": float(np.percentile(ious, 10)) if ious.size else None,
            "score_delta_mean": float(sd.mean()) if sd.size else None,
            "score_delta_max": float(sd.max()) if sd.size else None,
        }
    return out


def official_ap(gt_annos, dt_annos, dataset, class_names):
    """The official protocol's result dict (TJ4D: its float keys)."""
    if dataset == "tj4d":
        _, res = tj4d_official_eval(gt_annos, dt_annos)
        return {k: v for k, v in res.items() if isinstance(v, float)}
    _, res = vod_official_eval(gt_annos, dt_annos, class_names=class_names)
    return res


def report(annos_a, annos_b, gt_annos, dataset="vod", score_thresh=0.1) -> dict:
    """The match statistics, each run's AP, their deltas and the largest."""
    class_names = (["Car", "Pedestrian", "Cyclist"] if dataset == "vod"
                   else ["Car", "Pedestrian", "Cyclist", "Truck"])
    match = analyze(annos_a, annos_b, class_names, score_thresh)
    ap_a = official_ap(gt_annos, annos_a, dataset, class_names)
    ap_b = official_ap(gt_annos, annos_b, dataset, class_names)
    dap = {k: ap_b.get(k, 0.0) - v for k, v in ap_a.items() if isinstance(v, float)}
    worst = max([abs(v) for v in dap.values()], default=0.0)
    return {"match": match, "ap_a": ap_a, "ap_b": ap_b, "dap": dap, "max_abs_dap": worst}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--a", required=True, help="result.pkl of run A (gather)")
    p.add_argument("--b", required=True, help="result.pkl of run B (polar)")
    p.add_argument("--infos", required=True, help="kitti_infos_val.pkl (the gt)")
    p.add_argument("--dataset", default="vod", choices=["vod", "tj4d"])
    p.add_argument("--score_thresh", type=float, default=0.1)
    p.add_argument("--json", default=None, help="write the full report here")
    args = p.parse_args(argv)

    with open(args.a, "rb") as f:
        annos_a = pickle.load(f)
    with open(args.b, "rb") as f:
        annos_b = pickle.load(f)
    with open(args.infos, "rb") as f:
        gt_annos = [info["annos"] for info in pickle.load(f)][: len(annos_a)]
    out = report(annos_a, annos_b, gt_annos, args.dataset, args.score_thresh)

    print(f"== box-level match (score >= {args.score_thresh}) ==")
    print(f"{'class':12s} {'nA':>5s} {'nB':>5s} {'match':>6s} {'rate':>6s} "
          f"{'iou_med':>8s} {'iou_p10':>8s} {'d_score':>8s}")

    def num(v):
        return -1 if v is None else v

    for c, st in out["match"].items():
        print(f"{c:12s} {st['n_a']:5d} {st['n_b']:5d} {st['matched']:6d} "
              f"{st['match_rate']:6.3f} {num(st['iou_median']):8.3f} "
              f"{num(st['iou_p10']):8.3f} {num(st['score_delta_mean']):8.4f}")
    print("== official AP (A | B | delta) ==")
    for k in sorted(out["dap"]):
        print(f"{k:42s} {out['ap_a'][k]:7.2f} {out['ap_b'].get(k, 0.0):7.2f} "
              f"{out['dap'][k]:+7.2f}")
    print(f"max |dAP| over all keys: {out['max_abs_dap']:.2f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
