"""The TransFusion-L head: a transformer decoder over BEV features whose
queries start at the peaks of a class heatmap, matched to the gt boxes as a
set (Hungarian) in training; no NMS at inference.

Counterpart of ``hgsfusion_tpu/models/transfusion_head.py``
(``PositionEmbeddingLearned``, ``TransformerDecoderLayer``, ``_Branch``,
``TransFusionHead``, ``encode_transfusion_boxes``,
``decode_transfusion_boxes``, ``hungarian_match``, ``gaussian_focal_loss``,
``transfusion_loss``, ``transfusion_get_boxes``). Parameter names are the
JAX package's (its converter maps none of the reference's); the attention
modules take torch ``MultiheadAttention``'s layout (``in_proj_weight`` rows
[Wq; Wk; Wv], ``in_proj_bias``, ``out_proj``) with flax's per-head split
(contiguous slices of features / heads) and its scaling of the query before
the product.

Proposals: the top min(P, C H W) of the peak map flattened as c H W + pos,
by a stable descending sort, so equal scores rank by index as JAX's
``exact_top_k`` ranks them. The assignment is solved on the host, as the
reference pcdet ``HungarianAssigner3D`` does: one (B, P, M) cost tensor
read back a step, ``scipy.optimize.linear_sum_assignment`` per frame, the
matches copied back; padded gt columns carry JAX's constant 1e4 cost and
their matches are dropped. JAX solves it on the device (optax); both give
the same assignment wherever the optimum is unique.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nms import top_scores
from ..ops.rotated_iou import boxes_iou3d
from ..utils.common import device_constant
from .center_head import center_targets
from .layers import batch_norm, compute_dtype, conv_nhwc


class PositionEmbeddingLearned(nn.Module):
    """MLP position embedding of (x, y): ``fc1`` -> ``bn`` -> ReLU -> ``fc2``."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(2, features)
        self.bn = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)
        self.fc2 = nn.Linear(features, features)

    def forward(self, xy):
        dt = compute_dtype(self.dtype)
        h = F.linear(xy.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        h = torch.relu(batch_norm(h, self.bn, dt))
        return F.linear(h, self.fc2.weight.to(dt), self.fc2.bias.to(dt))


class MultiheadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (in = out = ``channels``) in
    torch ``MultiheadAttention``'s parameter layout."""

    def __init__(self, channels: int, heads: int, dtype=None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        self.out_proj = nn.Linear(channels, channels)

    def forward(self, q, k, v):
        dt = compute_dtype(self.dtype)
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        (wq, wk, wv), (bq, bk, bv) = w.chunk(3), bias.chunk(3)
        b, nq, c = q.shape
        nk, h = k.shape[1], self.heads
        d = c // h
        qp = F.linear(q.to(dt), wq, bq).reshape(b, nq, h, d).transpose(1, 2) / math.sqrt(d)
        kp = F.linear(k.to(dt), wk, bk).reshape(b, nk, h, d).transpose(1, 2)
        vp = F.linear(v.to(dt), wv, bv).reshape(b, nk, h, d).transpose(1, 2)
        attn = (qp @ kp.transpose(-2, -1)).float().softmax(-1).to(dt)
        out = (attn @ vp).transpose(1, 2).reshape(b, nq, c)
        return F.linear(out, self.out_proj.weight.to(dt), self.out_proj.bias.to(dt))


def _layer_norm(x, ln):
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype), ln.bias.to(x.dtype),
                        ln.eps)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention over the queries (plus their
    position embedding), cross-attention to the BEV keys, whose value also
    carries the key position embedding, and a ReLU FFN."""

    def __init__(self, features: int, num_heads: int, ffn: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.self_posembed = PositionEmbeddingLearned(features, dtype)
        self.cross_posembed = PositionEmbeddingLearned(features, dtype)
        self.self_attn = MultiheadAttention(features, num_heads, dtype)
        self.norm1 = nn.LayerNorm(features, eps=1e-5)
        self.cross_attn = MultiheadAttention(features, num_heads, dtype)
        self.norm2 = nn.LayerNorm(features, eps=1e-5)
        self.linear1 = nn.Linear(features, ffn)
        self.linear2 = nn.Linear(ffn, features)
        self.norm3 = nn.LayerNorm(features, eps=1e-5)

    def forward(self, query, key, query_pos, key_pos):
        dt = compute_dtype(self.dtype)
        qe = self.self_posembed(query_pos)
        ke = self.cross_posembed(key_pos)
        q = query + qe
        query = _layer_norm(query + self.self_attn(q, q, q), self.norm1)
        kv = key + ke
        query = _layer_norm(query + self.cross_attn(query + qe, kv, kv), self.norm2)
        f = F.linear(query.to(dt), self.linear1.weight.to(dt), self.linear1.bias.to(dt))
        f = F.linear(torch.relu(f), self.linear2.weight.to(dt), self.linear2.bias.to(dt))
        return _layer_norm(query + f, self.norm3)


class _Branch(nn.Module):
    """Per-query prediction: ``fc`` (64, no bias) -> ``bn`` -> ReLU ->
    ``out``; f32 out."""

    def __init__(self, channels: int, out: int, hidden: int = 64, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(channels, hidden, bias=False)
        self.bn = nn.BatchNorm1d(hidden, eps=1e-5, momentum=0.1)
        self.out = nn.Linear(hidden, out)

    def forward(self, x):
        dt = compute_dtype(self.dtype)
        h = torch.relu(batch_norm(F.linear(x.to(dt), self.fc.weight.to(dt)), self.bn, dt))
        return F.linear(h, self.out.weight.to(dt), self.out.bias.to(dt)).float()


HEAD_BRANCHES = (("center", 2), ("height", 1), ("dim", 3), ("rot", 2))
HEATMAP_PRIOR = -2.19  # the query heatmap branch's initial bias


class TransFusionHead(nn.Module):
    """Heatmap-initialized query decoder head (one decoder layer) over NHWC
    BEV features. Returns dense_heatmap (B, H, W, C) f32; per query heatmap
    (B, P, C), center (B, P, 2) in feature-map cells, height (B, P, 1), dim
    (B, P, 3) log, rot (B, P, 2) (sin, cos); query_labels (B, P) int64,
    query_heatmap_score (B, P, C), query_pos (B, P, 2)."""

    def __init__(self, in_channels: int, num_class: int, hidden: int = 128,
                 num_proposals: int = 200, num_heads: int = 8, ffn: int = 256,
                 nms_kernel_size: int = 3, no_pool_classes: Tuple[int, ...] = (), dtype=None):
        super().__init__()
        self.num_class, self.hidden, self.num_proposals = num_class, hidden, num_proposals
        self.nms_kernel_size, self.no_pool_classes = nms_kernel_size, tuple(no_pool_classes)
        self.dtype = dtype
        self.shared_conv = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.hm_conv1 = nn.Conv2d(hidden, hidden, 3, padding=1, bias=False)
        self.hm_bn = nn.BatchNorm2d(hidden, eps=1e-5, momentum=0.1)
        self.hm_out = nn.Conv2d(hidden, num_class, 3, padding=1)
        self.class_encoding = nn.Linear(num_class, hidden)
        self.decoder = TransformerDecoderLayer(hidden, num_heads, ffn, dtype)
        for name, out in HEAD_BRANCHES + (("heatmap", num_class),):
            setattr(self, name, _Branch(hidden, out, dtype=dtype))

    def init_biases(self):
        """The query heatmap branch's prior bias (JAX's ``init_bias``)."""
        with torch.no_grad():
            self.heatmap.out.bias.fill_(HEATMAP_PRIOR)

    def forward(self, feats):
        b, h, w, _ = feats.shape
        dt = compute_dtype(self.dtype)
        lidar_feat = conv_nhwc(feats, self.shared_conv, dt)
        hm = torch.relu(batch_norm(conv_nhwc(lidar_feat, self.hm_conv1, dt), self.hm_bn, dt))
        dense_heatmap = conv_nhwc(hm, self.hm_out, dt).float()

        # peak NMS: interior max-pool, zero border; no gradient (the
        # reference's .detach())
        heat = torch.sigmoid(dense_heatmap).detach()
        k = self.nms_kernel_size
        pad = k // 2
        inner = F.max_pool2d(heat.permute(0, 3, 1, 2), k, 1).permute(0, 2, 3, 1)
        local_max = F.pad(inner, (0, 0, pad, pad, pad, pad))
        if self.no_pool_classes:
            exempt = device_constant(tuple(c in self.no_pool_classes
                                           for c in range(self.num_class)), torch.bool,
                                     heat.device)
            local_max = torch.where(exempt, heat, local_max)
        peaks = heat * (heat == local_max)

        # the top proposals over (C, H W) flattened as c H W + pos
        p_eff = min(self.num_proposals, self.num_class * h * w)
        peaks_chw = peaks.permute(0, 3, 1, 2).reshape(b, self.num_class, h * w)
        _, idx = top_scores(peaks_chw.reshape(b, -1), p_eff)
        query_labels = torch.div(idx, h * w, rounding_mode="floor")
        spatial = idx % (h * w)
        feat_flat = lidar_feat.reshape(b, h * w, self.hidden)
        query_feat = torch.take_along_dim(feat_flat, spatial[..., None], dim=1)
        one_hot = F.one_hot(query_labels, self.num_class).to(query_feat.dtype)
        enc = self.class_encoding
        query_feat = query_feat + F.linear(one_hot, enc.weight.to(dt), enc.bias.to(dt))

        # (x, y) at cell centers
        query_pos = torch.stack([(spatial % w).float() + 0.5,
                                 torch.div(spatial, w, rounding_mode="floor").float() + 0.5], -1)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=feats.device),
                                torch.arange(w, dtype=torch.float32, device=feats.device),
                                indexing="ij")
        bev_pos = torch.stack([gx + 0.5, gy + 0.5], -1).reshape(1, h * w, 2).expand(b, -1, -1)
        query_feat = self.decoder(query_feat, feat_flat, query_pos, bev_pos)

        out = {name: getattr(self, name)(query_feat) for name, _ in HEAD_BRANCHES}
        out["center"] = out["center"] + query_pos
        # gathered from the post-peak map: a class scores at a query's cell
        # only where it also peaks there
        q_hm_score = torch.take_along_dim(peaks_chw, spatial[:, None, :], dim=2).transpose(1, 2)
        return {"dense_heatmap": dense_heatmap, "heatmap": self.heatmap(query_feat), **out,
                "query_labels": query_labels, "query_heatmap_score": q_hm_score,
                "query_pos": query_pos}


def encode_transfusion_boxes(boxes, pc_range, voxel_size, stride):
    """(..., 7) lidar boxes -> (..., 8) targets: [cx, cy in feature cells,
    z, log dims, sin, cos]."""
    cx = (boxes[..., 0] - pc_range[0]) / (voxel_size[0] * stride)
    cy = (boxes[..., 1] - pc_range[1]) / (voxel_size[1] * stride)
    safe_dims = torch.clamp(boxes[..., 3:6], min=1e-6)
    return torch.cat([cx[..., None], cy[..., None], boxes[..., 2:3], torch.log(safe_dims),
                      torch.sin(boxes[..., 6:7]), torch.cos(boxes[..., 6:7])], dim=-1)


def decode_transfusion_boxes(preds, pc_range, voxel_size, stride):
    """Per-query boxes (B, P, 7) from the branch outputs."""
    cx = preds["center"][..., 0] * stride * voxel_size[0] + pc_range[0]
    cy = preds["center"][..., 1] * stride * voxel_size[1] + pc_range[1]
    dims = torch.exp(torch.clamp(preds["dim"], -10.0, 10.0))
    angle = torch.atan2(preds["rot"][..., 0], preds["rot"][..., 1])
    return torch.stack([cx, cy, preds["height"][..., 0], dims[..., 0], dims[..., 1],
                        dims[..., 2], angle], dim=-1)


PAD_COST = 1e4  # a padded gt column's cost


def assignment_costs(pred_boxes, pred_logits, gt_boxes, gt_labels, gt_valid, pc_range,
                     cls_weight=0.15, reg_weight=0.25, iou_weight=0.25, alpha=0.25, gamma=2.0):
    """The (B, P, M) matching cost (focal class cost + normalized L1 of the
    BEV centers - 3-D IoU; PAD_COST on padded columns) and the (B, P, M) IoU."""
    p = torch.sigmoid(pred_logits)
    eps = 1e-12
    neg_cost = -torch.log(1 - p + eps) * (1 - alpha) * torch.pow(p, gamma)
    pos_cost = -torch.log(p + eps) * alpha * torch.pow(1 - p, gamma)
    lab = gt_labels[:, None, :].expand(-1, p.shape[1], -1)
    cls_cost = (torch.take_along_dim(pos_cost, lab, dim=2)
                - torch.take_along_dim(neg_cost, lab, dim=2)) * cls_weight
    lo = device_constant(tuple(pc_range[0:2]), pred_boxes.dtype, pred_boxes.device)
    span = device_constant(tuple(np.subtract(pc_range[3:5], pc_range[0:2]).tolist()),
                           pred_boxes.dtype, pred_boxes.device)
    nb = (pred_boxes[..., :2] - lo) / span
    ng = (gt_boxes[..., :2] - lo) / span
    reg_cost = (nb[:, :, None] - ng[:, None]).abs().sum(-1) * reg_weight
    iou = torch.stack([boxes_iou3d(pb, gb) for pb, gb in zip(pred_boxes, gt_boxes)])
    cost = cls_cost + reg_cost - iou * iou_weight
    return torch.where(gt_valid[:, None, :], cost, torch.full_like(cost, PAD_COST)), iou


def solve_assignment(cost) -> np.ndarray:
    """Minimal-cost matches of each frame's (P, M) cost on the host: (B, P)
    int64, the gt column matched to each proposal or -1. The only read of
    the step back to the host."""
    from scipy.optimize import linear_sum_assignment

    host = cost.detach().float().cpu().numpy()
    matched = np.full(host.shape[:2], -1, np.int64)
    for i, c in enumerate(host):
        rows, cols = linear_sum_assignment(c)
        matched[i, rows] = cols
    return matched


def hungarian_match(pred_boxes, pred_logits, gt_boxes, gt_labels, gt_valid, pc_range, **costs):
    """Assign gts to proposals by minimal (focal + L1-bev - IoU3D) cost,
    frames batched: (matched_gt (B, P) int64, -1 where unmatched; pos (B, P)
    bool; iou (B, P), the matched pair's, 0 elsewhere). Matches of a padded
    gt column are dropped."""
    cost, iou = assignment_costs(pred_boxes, pred_logits, gt_boxes, gt_labels, gt_valid,
                                 pc_range, **costs)
    matched = torch.from_numpy(solve_assignment(cost))
    if cost.is_cuda:
        matched = matched.pin_memory().to(cost.device, non_blocking=True)
    safe = torch.clamp(matched, min=0)
    matched = torch.where((matched >= 0) & torch.take_along_dim(gt_valid, safe, dim=1),
                          matched, torch.full_like(matched, -1))
    pos = matched >= 0
    iou_per_prop = torch.take_along_dim(iou, safe[..., None], dim=2)[..., 0]
    return matched, pos, torch.where(pos, iou_per_prop, torch.zeros_like(iou_per_prop))


def gaussian_focal_loss(pred_sigmoid, gt, alpha: float = 2.0, gamma: float = 4.0):
    """Penalty-reduced focal loss on a gaussian heatmap, summed (the caller
    normalizes by the peaks)."""
    eps = 1e-12
    pos = (gt == 1.0).to(pred_sigmoid.dtype)
    neg_w = torch.pow(1 - gt, gamma)
    pos_l = -torch.log(pred_sigmoid + eps) * torch.pow(1 - pred_sigmoid, alpha) * pos
    neg_l = -torch.log(1 - pred_sigmoid + eps) * torch.pow(pred_sigmoid, alpha) * neg_w
    return (pos_l + neg_l).sum()


def transfusion_loss(preds: Dict, gt_boxes, num_class: int, pc_range, voxel_size, stride,
                     feature_map_hw: Tuple[int, int], cls_weight=1.0, bbox_weight=0.25,
                     hm_weight=1.0, code_weights: Sequence[float] = (1.0,) * 8,
                     gaussian_overlap=0.1, min_radius=2):
    """The TransFusion loss over padded gt boxes (B, M, 8): the dense
    heatmap's gaussian focal loss, and on the Hungarian matches the
    proposals' focal class loss and the L1 of their encoded boxes. Returns
    (total, {loss_heatmap, loss_cls_trans, loss_bbox, matched_ious})."""
    gt_valid = gt_boxes[..., -1] > 0
    gt_labels = torch.clamp(gt_boxes[..., -1].to(torch.int64) - 1, min=0)
    pred_boxes = decode_transfusion_boxes(preds, pc_range, voxel_size, stride).detach()
    matched_gt, pos, ious = hungarian_match(pred_boxes, preds["heatmap"].detach(),
                                            gt_boxes[..., :7], gt_labels, gt_valid, pc_range)
    num_pos = torch.clamp(pos.float().sum(), min=1.0)

    targets = center_targets(gt_boxes, num_class, feature_map_hw, stride, pc_range, voxel_size,
                             gaussian_overlap=gaussian_overlap, min_radius=min_radius)
    hm_pred = torch.clamp(torch.sigmoid(preds["dense_heatmap"]), 1e-4, 1 - 1e-4)
    n_peaks = torch.clamp((targets["heatmap"] == 1.0).sum().float(), min=1.0)
    loss_hm = gaussian_focal_loss(hm_pred, targets["heatmap"]) / n_peaks

    safe = torch.clamp(matched_gt, min=0)
    tgt_label = torch.take_along_dim(gt_labels, safe, dim=1)
    onehot = F.one_hot(tgt_label, num_class).float() * pos[..., None]
    p = torch.clamp(torch.sigmoid(preds["heatmap"]), 1e-6, 1 - 1e-6)
    pt = onehot * p + (1 - onehot) * (1 - p)
    focal = -torch.pow(1 - pt, 2.0) * torch.log(pt)
    alpha_w = onehot * 0.25 + (1 - onehot) * 0.75
    loss_cls = (alpha_w * focal).sum() / num_pos

    tgt_boxes = torch.take_along_dim(gt_boxes[..., :7], safe[..., None], dim=1)
    enc = encode_transfusion_boxes(tgt_boxes, pc_range, voxel_size, stride)
    pred_enc = torch.cat([preds["center"], preds["height"], preds["dim"], preds["rot"]], -1)
    cw = device_constant(tuple(float(c) for c in code_weights), torch.float32, pred_enc.device)
    loss_bbox = ((pred_enc - enc).abs() * pos[..., None] * cw).sum() / num_pos

    total = loss_hm * hm_weight + loss_cls * cls_weight + loss_bbox * bbox_weight
    return total, {"loss_heatmap": loss_hm, "loss_cls_trans": loss_cls, "loss_bbox": loss_bbox,
                   "matched_ious": ious.sum() / num_pos}


def transfusion_get_boxes(preds: Dict, pc_range, voxel_size, stride, score_thresh: float,
                          post_center_range) -> Dict[str, torch.Tensor]:
    """Fixed-shape detections, one per query: score = sigmoid(query heatmap)
    x query_heatmap_score at the query's class; valid where the score
    passes ``score_thresh`` and the center lies in ``post_center_range``.
    {"boxes" (B, P, 7), "scores", "labels" (1-based), "valid"}."""
    boxes = decode_transfusion_boxes(preds, pc_range, voxel_size, stride)
    one_hot = F.one_hot(preds["query_labels"], preds["heatmap"].shape[-1]).float()
    scores = (torch.sigmoid(preds["heatmap"]) * preds["query_heatmap_score"] * one_hot).sum(-1)
    lim = device_constant(tuple(float(v) for v in post_center_range), torch.float32,
                          boxes.device)
    ok = (boxes[..., :3] >= lim[:3]).all(-1) & (boxes[..., :3] <= lim[3:]).all(-1)
    return {"boxes": boxes, "scores": scores, "labels": preds["query_labels"] + 1,
            "valid": ok & (scores > score_thresh)}
