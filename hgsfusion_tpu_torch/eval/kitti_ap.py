"""KITTI-style AP evaluation core, pure numpy (no numba / CUDA).

A copy of ``hgsfusion_tpu/eval/kitti_ap.py``.

Reference: pcdet/utils/vod_utils.py (get_thresholds:7-27, clean_data:30-115,
compute_statistics_jit:189-320, eval_class:506-662, get_m_ap(_r40):608-621)
and datasets/kitti/kitti_object_eval_python/eval.py. The per-(gt, det)
greedy matching is kept (it defines the metric) but the inner detection scan
is vectorized; frames x thresholds run in plain numpy.

Conventions preserved exactly:
- overlaps are (num_det, num_gt) per frame;
- bev boxes are camera-frame (x, z, l, w, ry), 3d adds the y/h slab overlap
  with y measured downward from the box top (d3_box_overlap_kernel:155-179);
- ignored_gt in {-1 other-class, 0 valid, 1 neighbor-class-or-ignored};
- 41 recall sample points, AP_R40 = mean precision over points 1..40,
  AP_R11 = mean over points 0, 4, 8, ....
"""
from __future__ import annotations

import numpy as np

from .rotated_iou_np import rotate_iou_eval

NO_DETECTION = -10000000.0


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = 41):
    """Score thresholds hitting evenly spaced recall points (vod_utils:7-27)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < len(scores) - 1
        ):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def image_box_overlap(boxes, query_boxes, criterion: int = -1):
    """Axis-aligned 2D box overlap, (N, 4) x (K, 4) -> (N, K)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    x1 = np.maximum(boxes[:, None, 0], query_boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], query_boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
    iw = np.clip(x2 - x1, 0, None)
    ih = np.clip(y2 - y1, 0, None)
    inter = iw * ih
    area_a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_b = (query_boxes[:, 2] - query_boxes[:, 0]) * (
        query_boxes[:, 3] - query_boxes[:, 1]
    )
    if criterion == -1:
        denom = area_a[:, None] + area_b[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a[:, None], inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(area_b[None, :], inter.shape)
    else:
        denom = np.ones_like(inter)
    out = np.zeros_like(inter)
    pos = (iw > 0) & (ih > 0) & (denom > 0)
    out[pos] = inter[pos] / denom[pos]
    return out


def bev_box_overlap(boxes, q_boxes, criterion: int = -1):
    return rotate_iou_eval(boxes, q_boxes, criterion)


def d3_box_overlap(boxes, q_boxes, criterion: int = -1):
    """Camera-frame 3D overlap: BEV rotated intersection x height slab.

    boxes: (N, 7) camera [x, y, z, l, h, w, ry]; y grows downward, the box
    spans [y - h, y] (d3_box_overlap_kernel:155-179).
    """
    inter_bev = rotate_iou_eval(
        boxes[:, [0, 2, 3, 5, 6]], q_boxes[:, [0, 2, 3, 5, 6]], 2
    )
    n, k = inter_bev.shape
    if n == 0 or k == 0:
        return inter_bev
    top = np.minimum(boxes[:, None, 1], q_boxes[None, :, 1])
    bottom = np.maximum(
        boxes[:, None, 1] - boxes[:, None, 4], q_boxes[None, :, 1] - q_boxes[None, :, 4]
    )
    ih = top - bottom
    inter = np.where(ih > 0, ih * inter_bev, 0.0)
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (q_boxes[:, 3] * q_boxes[:, 4] * q_boxes[:, 5])[None, :]
    if criterion == -1:
        denom = vol_a + vol_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(vol_b, inter.shape)
    else:
        return np.where(inter_bev > 0, inter, 0.0)
    out = np.where((inter_bev > 0) & (denom > 0), inter / np.maximum(denom, 1e-12), 0.0)
    return out


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """One frame's tp/fp/fn (+AOS similarity) at one score threshold.

    Faithful port of compute_statistics_jit:189-320 with the inner detection
    scan vectorized. overlaps: (num_det, num_gt).
    """
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]
    ignored_gt = np.asarray(ignored_gt)
    ignored_det = np.asarray(ignored_det)

    assigned = np.zeros(det_size, bool)
    ignored_threshold = (
        dt_scores < thresh if compute_fp else np.zeros(det_size, bool)
    )

    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    deltas = []

    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        ov = overlaps[:, i]
        usable = (ignored_det != -1) & ~assigned & ~ignored_threshold
        above = usable & (ov > min_overlap)
        det_idx = -1
        valid_detection = NO_DETECTION
        if not compute_fp:
            cand = np.flatnonzero(above)
            if cand.size:
                det_idx = cand[np.argmax(dt_scores[cand])]
                valid_detection = dt_scores[det_idx]
        else:
            main = np.flatnonzero(above & (ignored_det == 0))
            if main.size:
                det_idx = main[np.argmax(ov[main])]
                valid_detection = 1.0
                assigned_ignored_det = False
            else:
                alt = np.flatnonzero(above & (ignored_det == 1))
                if alt.size:
                    det_idx = alt[0]
                    valid_detection = 1.0

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                deltas.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True

    if compute_fp:
        fp = int(
            np.sum(~assigned & (ignored_det == 0) & ~ignored_threshold)
        )
        n_stuff = 0
        if metric == 0 and len(dc_bboxes):
            ov_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
            for di in range(dc_bboxes.shape[0]):
                for j in range(det_size):
                    if assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]:
                        continue
                    if ov_dc[j, di] > min_overlap:
                        assigned[j] = True
                        n_stuff += 1
        fp -= n_stuff
        if compute_aos:
            sims = [(1.0 + np.cos(d)) / 2.0 for d in deltas]
            similarity = float(np.sum([0.0] * fp + sims)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def calculate_iou_per_frame(dt_annos, gt_annos, metric):
    """Per-frame (num_det, num_gt) overlap matrices."""
    overlaps = []
    for dt, gt in zip(dt_annos, gt_annos):
        if metric == 0:
            ov = image_box_overlap(
                np.asarray(dt["bbox"]).reshape(-1, 4),
                np.asarray(gt["bbox"]).reshape(-1, 4),
            )
        elif metric == 1:
            db = np.concatenate(
                [dt["location"][:, [0, 2]], dt["dimensions"][:, [0, 2]],
                 dt["rotation_y"][..., None]], axis=1,
            ) if len(dt["name"]) else np.zeros((0, 5))
            gb = np.concatenate(
                [gt["location"][:, [0, 2]], gt["dimensions"][:, [0, 2]],
                 gt["rotation_y"][..., None]], axis=1,
            ) if len(gt["name"]) else np.zeros((0, 5))
            ov = bev_box_overlap(db, gb).astype(np.float64)
        elif metric == 2:
            db = np.concatenate(
                [dt["location"], dt["dimensions"], dt["rotation_y"][..., None]],
                axis=1,
            ) if len(dt["name"]) else np.zeros((0, 7))
            gb = np.concatenate(
                [gt["location"], gt["dimensions"], gt["rotation_y"][..., None]],
                axis=1,
            ) if len(gt["name"]) else np.zeros((0, 7))
            ov = d3_box_overlap(db, gb).astype(np.float64)
        else:
            raise ValueError(metric)
        overlaps.append(ov)
    return overlaps


def _frame_data(anno, is_dt: bool):
    bbox = np.asarray(anno["bbox"]).reshape(-1, 4)
    alpha = np.asarray(anno["alpha"]).reshape(-1, 1)
    if is_dt:
        score = np.asarray(anno["score"]).reshape(-1, 1)
        return np.concatenate([bbox, alpha, score], axis=1)
    return np.concatenate([bbox, alpha], axis=1)


def eval_class(gt_annos, dt_annos, clean_data_fn, current_classes, difficulties,
               metric, min_overlaps, compute_aos=False,
               num_sample_pts: int = 41):
    """AP curve computation (eval_class:506-662).

    clean_data_fn(gt_anno, dt_anno, class_idx, difficulty) ->
      (num_valid_gt, ignored_gt, ignored_dt, dc_bboxes)
    min_overlaps: (num_overlap_tiers, 3 metrics, num_classes).
    Returns dict(recall, precision, orientation), each
    (num_class, num_difficulty, num_tiers, num_sample_pts).
    """
    assert len(gt_annos) == len(dt_annos)
    overlaps = calculate_iou_per_frame(dt_annos, gt_annos, metric)

    num_tiers = min_overlaps.shape[0]
    shape = (len(current_classes), len(difficulties), num_tiers, num_sample_pts)
    precision = np.zeros(shape)
    recall = np.zeros(shape)
    aos = np.zeros(shape)

    for m, cls_idx in enumerate(current_classes):
        for l, difficulty in enumerate(difficulties):
            frames = []
            total_num_valid_gt = 0
            for gt, dt in zip(gt_annos, dt_annos):
                num_valid_gt, ignored_gt, ignored_dt, dc = clean_data_fn(
                    gt, dt, cls_idx, difficulty
                )
                total_num_valid_gt += num_valid_gt
                dc = (
                    np.stack(dc).astype(np.float64)
                    if len(dc) else np.zeros((0, 4))
                )
                frames.append(
                    (
                        _frame_data(gt, False), _frame_data(dt, True),
                        np.asarray(ignored_gt, np.int64),
                        np.asarray(ignored_dt, np.int64), dc,
                    )
                )
            for k in range(num_tiers):
                min_overlap = min_overlaps[k, metric, m]
                all_thresholds = []
                for ov, (gtd, dtd, igt, idt, dc) in zip(overlaps, frames):
                    _, _, _, _, th = compute_statistics(
                        ov, gtd, dtd, igt, idt, dc, metric,
                        min_overlap=min_overlap, thresh=0.0, compute_fp=False,
                    )
                    all_thresholds.append(th)
                all_thresholds = np.concatenate(all_thresholds) if all_thresholds else np.zeros(0)
                if total_num_valid_gt == 0 or all_thresholds.size == 0:
                    continue
                thresholds = get_thresholds(
                    all_thresholds, total_num_valid_gt, num_sample_pts
                )
                pr = np.zeros((len(thresholds), 4))
                for ov, (gtd, dtd, igt, idt, dc) in zip(overlaps, frames):
                    for t, thr in enumerate(thresholds):
                        tp, fp, fn, sim, _ = compute_statistics(
                            ov, gtd, dtd, igt, idt, dc, metric,
                            min_overlap=min_overlap, thresh=thr,
                            compute_fp=True, compute_aos=compute_aos,
                        )
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if sim != -1:
                            pr[t, 3] += sim
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 2], 1e-12)
                    precision[m, l, k, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 1], 1e-12)
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / max(pr[i, 0] + pr[i, 1], 1e-12)
                # right-max envelope (eval_class:652-658)
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:])
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:])
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:])
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_map_r11(prec):
    """11-point AP (get_m_ap:608-613): every 4th of the 41 samples."""
    return sum(prec[..., i] for i in range(0, prec.shape[-1], 4)) / 11 * 100


def get_map_r40(prec):
    """40-point AP (get_m_ap_r40:616-621): samples 1..40."""
    return sum(prec[..., i] for i in range(1, prec.shape[-1])) / 40 * 100
