"""Rotated NMS on the device, fixed-shape outputs.

Counterpart of ``hgsfusion_tpu/ops/nms.py`` (greedy_nms_lazy,
class_agnostic_nms). The reference NMS sweeps its suppression bitmask on the
CPU; here the greedy sweep of a whole batch is one op,
``hgsfusion::nms_lazy`` (``ops/library.py``): on the card two launches of
``csrc/nms_lazy.cu`` (the pairwise suppression mask on every SM, then the
sweep), which read nothing back to the host, so a served frame's
post-processing never waits for the device and traces into the exported
graph. On the CPU the op takes the plain version, ``greedy_nms_lazy_plain``,
whose one host read (the candidate count) bounds its loop. The kernels'
two phases have their own plain versions, ``nms_mask_plain`` and
``nms_sweep_plain``, which the card's mask is held to.
"""
from __future__ import annotations

import torch

from . import library
from .library import nms_lazy_op
from .rotated_iou import boxes_iou_bev

# masked-score sentinel: scores are sigmoid probabilities in [0, 1]
NEG_INF = -1.0


def top_scores(flat, k: int):
    """The ``k`` largest of each row of ``flat`` (B, N), descending, equal
    values by index as JAX's ``exact_top_k`` ranks them (a stable sort):
    (values, indices)."""
    values, order = torch.sort(flat, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def greedy_nms_lazy_plain(boxes, valid, nms_thresh: float, max_keep: int,
                          row_block: int = 256):
    """Greedy rotated NMS over score-sorted candidates, the plain version of
    ``csrc/nms_lazy.cu``: boxes (N, 7), valid (N,) bool.

    Same keep set as the JAX ``greedy_nms_lazy``: walk the valid candidates
    in order, keep each one not suppressed (IoU > nms_thresh) by an earlier
    kept one, stop after ``max_keep`` kept. Returns keep (N,) bool.
    """
    n = boxes.shape[0]
    device = boxes.device
    cand = torch.nonzero(valid).squeeze(1)  # the one host read: the count
    nv = cand.numel()
    iters = min(max_keep, nv)
    if iters == 0:
        return torch.zeros(n, dtype=torch.bool, device=device)
    sub = boxes[cand]
    order = torch.arange(nv, device=device)
    # survives[i, j]: candidate j > i is not suppressed by a kept candidate i
    survives = torch.empty((nv, nv), dtype=torch.bool, device=device)
    for r0 in range(0, nv, row_block):
        rows = slice(r0, min(r0 + row_block, nv))
        survives[rows] = ((boxes_iou_bev(sub[rows], sub) <= nms_thresh)
                          & (order[None, :] > order[rows, None]))
    alive = torch.ones(nv, dtype=torch.bool, device=device)
    picks = torch.empty(iters, dtype=torch.long, device=device)
    for s in range(iters):
        i = torch.argmax(alive.to(torch.uint8)).view(1)  # first alive (0 if none)
        picks[s:s + 1] = i
        alive &= survives.index_select(0, i)[0]
    # picks increase while candidates remain; once none is alive argmax gives 0
    picked = torch.ones(iters, dtype=torch.bool, device=device)
    picked[1:] = picks[1:] > picks[:-1]
    hits = torch.zeros(n, dtype=torch.int32, device=device)
    hits.index_put_((cand[picks],), picked.to(torch.int32), accumulate=True)
    return hits > 0


def nms_mask_plain(boxes, valid, nms_thresh: float, row_block: int = 256):
    """The plain version of ``csrc/nms_lazy.cu``'s ``nms_mask``: boxes (K,
    7), valid (K,) bool -> (K, ceil(K / 64)) int64 words, bit j % 64 of word
    j // 64 of row i set where candidates i < j are both valid and IoU_bev(box
    i, box j) > nms_thresh; every other bit 0 (the kernel leaves the words
    of row tiles without a valid candidate, and those before a row's own
    tile, unwritten)."""
    k = boxes.shape[0]
    device = boxes.device
    tiles = -(-k // library.NMS_TILE)
    bits = torch.zeros((k, tiles * library.NMS_TILE), dtype=torch.bool, device=device)
    cand = torch.nonzero(valid).squeeze(1)
    sub = boxes[cand]
    for r0 in range(0, cand.numel(), row_block):
        rows = cand[r0:r0 + row_block]
        doomed = (boxes_iou_bev(sub[r0:r0 + row_block], sub) > nms_thresh) \
            & (cand[None, :] > rows[:, None])
        bits[rows[:, None], cand[None, :]] = doomed
    shifts = torch.arange(library.NMS_TILE, device=device)
    # bit 63 wraps to the sign bit: the sum of distinct powers of two is exact
    return (bits.view(k, tiles, library.NMS_TILE).to(torch.int64) << shifts).sum(-1)


def nms_sweep_plain(mask, valid, max_keep: int):
    """The plain version of ``csrc/nms_lazy.cu``'s ``nms_sweep``: the greedy
    keep set (K,) bool over a mask of ``nms_mask_plain``'s form, walked as
    the kernel walks it: tile by tile, each tile's live candidates resolved
    one after the other against their words of that tile (one host read a
    tile), then the kept rows' words of the later tiles suppressing."""
    k = valid.shape[0]
    t = library.NMS_TILE
    tiles = mask.shape[1]
    shifts = torch.arange(t, device=mask.device)
    bits = ((mask[..., None] >> shifts) & 1).bool().view(k, tiles * t)[:, :k]
    suppressed = torch.zeros(k, dtype=torch.bool, device=mask.device)
    keep = torch.zeros(k, dtype=torch.bool, device=mask.device)
    kept = 0
    for r0 in range(0, k, t):
        if kept >= max_keep:
            break
        rows = slice(r0, min(r0 + t, k))
        live = (valid[rows] & ~suppressed[rows]).tolist()
        diag = bits[rows, rows].tolist()
        taken = []
        for a in range(len(live)):
            if live[a] and kept < max_keep:
                taken.append(r0 + a)
                kept += 1
                live = [v and not d for v, d in zip(live, diag[a])]
        if taken:
            idx = torch.tensor(taken, device=mask.device)
            keep[idx] = True
            suppressed[rows.stop:] |= bits[idx, rows.stop:].any(0)
    return keep


def _select(box_scores, box_preds, score_thresh: float, k: int, valid=None):
    """Score threshold -> top ``k`` of (B, N) scores: (top scores (B, k)
    with NEG_INF where none passed, their indices, their boxes (B, k, C)).
    Equal scores rank by index (``top_scores``)."""
    ok = box_scores >= score_thresh
    if valid is not None:
        ok = ok & valid
    masked = torch.where(ok, box_scores, torch.full_like(box_scores, NEG_INF))
    top_s, top_idx = top_scores(masked, k)
    return top_s, top_idx, torch.take_along_dim(box_preds, top_idx[..., None], dim=1)


def kept_slots(top_s, top_boxes, top_idx, nms_thresh: float, post_max_size: int):
    """One ``hgsfusion::nms_lazy`` call over the frames of (F, k)
    score-sorted candidates -> (indices (F, post_max) of the first
    ``post_max_size`` kept, in score order, valid mask (F, post_max));
    empty slots hold index 0."""
    keep = nms_lazy_op(top_boxes[..., :7].float().contiguous(), top_s > NEG_INF / 2,
                       float(nms_thresh), int(post_max_size))
    rank = torch.cumsum(keep.to(torch.int64), -1) - 1
    slot = torch.where(keep & (rank < post_max_size), rank,
                       torch.full_like(rank, post_max_size))
    frames = top_s.shape[0]
    out_idx = torch.zeros((frames, post_max_size + 1), dtype=top_idx.dtype,
                          device=top_idx.device)
    out_idx.scatter_(1, slot, top_idx)
    out_valid = torch.zeros((frames, post_max_size + 1), dtype=torch.bool,
                            device=top_idx.device)
    out_valid.scatter_(1, slot, True)
    return out_idx[:, :post_max_size], out_valid[:, :post_max_size]


def class_agnostic_nms(box_scores, box_preds, score_thresh: float,
                       nms_thresh: float, pre_max_size: int, post_max_size: int,
                       valid=None):
    """Score threshold -> top ``pre_max_size`` -> rotated NMS -> first
    ``post_max_size`` kept in score order, for scores (..., N) and boxes
    (..., N, 7), a leading batch dimension or none; the batch's NMS is one
    ``hgsfusion::nms_lazy`` call. Returns (indices (..., post_max) into the
    inputs, valid mask (..., post_max)); empty slots hold index 0. Equal
    scores rank by index (``_select``)."""
    batched = box_scores.dim() == 2
    if not batched:
        box_scores, box_preds = box_scores[None], box_preds[None]
        valid = None if valid is None else valid[None]
    k = min(pre_max_size, box_scores.shape[-1])
    top_s, top_idx, top_boxes = _select(box_scores, box_preds, score_thresh, k, valid)
    out_idx, out_valid = kept_slots(top_s, top_boxes, top_idx, nms_thresh, post_max_size)
    return (out_idx, out_valid) if batched else (out_idx[0], out_valid[0])


def multi_set_nms(set_scores, set_boxes, score_thresh: float, nms_thresh: float,
                  pre_max_size: int, post_max_size: int):
    """``class_agnostic_nms`` of S candidate sets per frame (the per-class
    NMS of a multi-class head): ``set_scores`` S tensors (B, N_s),
    ``set_boxes`` S tensors (B, N_s, >= 7). Every set's top candidates are
    stacked as frames of one ``hgsfusion::nms_lazy`` call (B x S frames:
    one ``nms_mask`` and one ``nms_sweep`` launch on the card), a set with
    fewer than the others padded with invalid ones. Returns (indices (B, S,
    post_max) into each set, valid mask (B, S, post_max)), each set's keep
    set the one ``class_agnostic_nms`` gives it alone."""
    bsz, n_sets = set_scores[0].shape[0], len(set_scores)
    k = max(min(pre_max_size, s.shape[-1]) for s in set_scores)
    tops = []
    for s, b in zip(set_scores, set_boxes):
        ts, ti, tb = _select(s, b[..., :7], score_thresh, min(pre_max_size, s.shape[-1]))
        if ts.shape[-1] < k:
            pad = k - ts.shape[-1]
            ts = torch.cat([ts, ts.new_full((bsz, pad), NEG_INF)], dim=1)
            ti = torch.cat([ti, ti.new_zeros((bsz, pad))], dim=1)
            tb = torch.cat([tb, tb.new_zeros((bsz, pad, 7))], dim=1)
        tops.append((ts, ti, tb))
    ts, ti, tb = (torch.stack(x, dim=1).flatten(0, 1) for x in zip(*tops))
    out_idx, out_valid = kept_slots(ts, tb, ti, nms_thresh, post_max_size)
    return (out_idx.reshape(bsz, n_sets, post_max_size),
            out_valid.reshape(bsz, n_sets, post_max_size))
