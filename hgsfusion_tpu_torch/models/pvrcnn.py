"""The two-stage RoI pieces the anchor-RPN families share: set abstraction
over grouped points, voxel stages as point sets, the RoI grid, the RCNN
head, the proposal layer, the RoI targets and the second-stage losses.

Counterpart of the shared part of ``hgsfusion_tpu/models/pvrcnn.py``
(``_GroupMLP``, ``SALayer``, ``_stage_point_set``, ``generate_proposals``,
``roi_targets``, ``canonical_reg_targets``, ``decode_canonical``,
``roi_grid_points``, ``RCNNHead``, ``rcnn_losses``); PV-RCNN's own parts
(the keypoint set abstraction, VectorPool) are not ported. As there:

- everything is fixed-shape: the proposals are the top 512 RPN boxes by
  score (ties by index, ``ops/nms.py::top_scores``), rotated NMS at
  ``NMS_THRESH_TRAIN`` keeping the first ``NUM_ROIS`` (one
  ``hgsfusion::nms_lazy`` call a batch), zeros in the unfilled slots;
- every valid RoI trains: its classification target is its best 3-D IoU
  with a gt box mapped linearly from [0.25, 0.75] to [0, 1], and RoIs at
  IoU 0.55 or more regress the canonical residual of their gt box
  (no random sampling, no corner loss);
- the grouped MLP's train-mode BatchNorm takes its statistics over every
  grouped row, the empty groups' included, before they are masked.

Parameter names are JAX's (``mlp_r{i}.fc{j}`` / ``bn{j}``; the RCNN head's
``fc0``, ``bn0``, ``fc1``, ``bn1``, ``cls``, ``reg``), as torch ``Linear``
and ``BatchNorm1d`` (flax momentum 0.9 is torch's 0.1).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nms import kept_slots, top_scores
from ..ops.pointnet2 import grid_axes, grid_centers, query_and_group
from ..ops.rotated_iou import boxes_iou3d
from .anchor_head import weighted_smooth_l1
from .layers import batch_norm, compute_dtype


def linear(x, fc: nn.Linear, dtype):
    """``fc`` applied in ``dtype`` (a flax ``Dense`` of that dtype)."""
    return F.linear(x.to(dtype), fc.weight.to(dtype), None if fc.bias is None
                    else fc.bias.to(dtype))


class GroupMLP(nn.Module):
    """The shared per-point MLP of a set abstraction (``fc{i}`` without
    bias, ``bn{i}``, ReLU) over (B, K, S, C) grouped rows, the empty
    groups' rows zeroed after it, then the max over each group's S."""

    def __init__(self, in_channels: int, mlps: Sequence[int], dtype=None):
        super().__init__()
        self.dtype, self.depth = dtype, len(mlps)
        for i, c in enumerate(mlps):
            setattr(self, f"fc{i}", nn.Linear(in_channels, c, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm1d(c, eps=1e-5, momentum=0.1))
            in_channels = c

    def forward(self, grouped, group_valid):
        dt = compute_dtype(self.dtype)
        h = grouped
        for i in range(self.depth):
            h = torch.relu(batch_norm(linear(h, getattr(self, f"fc{i}"), dt),
                                      getattr(self, f"bn{i}"), dt))
        h = h * group_valid[..., None].to(h.dtype)
        return h.amax(dim=2)


class SALayer(nn.Module):
    """Multi-radius set abstraction: per radius a ball query and grouping
    (``ops/pointnet2.py::query_and_group``), its ``mlp_r{i}``, the results
    concatenated. ``zero_empty``: the stack modules' empty-ball zeros (the
    batch modules group point 0 instead). ``in_channels``: the features'
    width, 3 more with the relative xyz."""

    def __init__(self, in_channels: int, radii: Tuple[float, ...], nsamples: Tuple[int, ...],
                 mlps, zero_empty: bool = True, dtype=None):
        super().__init__()
        self.radii, self.nsamples, self.zero_empty = tuple(radii), tuple(nsamples), zero_empty
        for i, m in enumerate(mlps):
            setattr(self, f"mlp_r{i}", GroupMLP(in_channels + 3, m, dtype))

    def forward(self, new_xyz, xyz, features, valid, grid=None):
        """new_xyz (B, K, 3), xyz (B, N, 3) (or (N, 3) for every frame),
        features (B, N, C), valid (B, N) -> (B, K, sum of the MLPs' last
        widths). ``grid``: ``query_and_group``'s, where ``xyz`` are a voxel
        grid's cell centres."""
        outs = []
        for i, (r, s) in enumerate(zip(self.radii, self.nsamples)):
            grouped, anys = [], []
            for f in range(new_xyz.shape[0]):
                pts = xyz if xyz.dim() == 2 else xyz[f]
                g, _, any_nb = query_and_group(new_xyz[f], pts, features[f], valid[f], r, s,
                                               zero_empty=self.zero_empty, grid=grid)
                grouped.append(g)
                anys.append(any_nb)
            grouped = torch.stack(grouped)
            gv = (torch.stack(anys)[..., None].expand(grouped.shape[:-1]) if self.zero_empty
                  else torch.ones(grouped.shape[:-1], dtype=torch.bool, device=grouped.device))
            outs.append(getattr(self, f"mlp_r{i}")(grouped, gv))
        return torch.cat(outs, dim=-1)


def stage_point_set(stage, pc_range, voxel_size):
    """A dense voxel stage (features (B, D, H, W, C), mask, stride) as a
    point set: (centres (D H W, 3) f32, features (B, D H W, C), valid (B, D
    H W)), and its grid (``query_and_group``'s ``grid``: axes, (z, y, x)
    pitch, (z, y, x) range minimum)."""
    feats, mask, ds = stage
    b, d, h, w, c = feats.shape
    axes = grid_axes((d, h, w), ds, pc_range, voxel_size, feats.device)
    pitch = tuple(voxel_size[a] * ds for a in (2, 1, 0))
    origin = tuple(pc_range[a] for a in (2, 1, 0))
    return (grid_centers(axes), feats.reshape(b, -1, c), mask.reshape(b, -1).bool(),
            (axes, pitch, origin))


def roi_grid_points(rois, grid_size: int):
    """(..., R, 7) RoIs -> (..., R, g^3, 3) global grid points, the cell
    centres of a g x g x g grid over each rotated box, (x, y, z) index
    order with x slowest."""
    g = grid_size
    r = torch.arange(g, dtype=torch.float32, device=rois.device)
    idx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    dims = rois[..., None, 3:6]
    local = (idx + 0.5) / g * dims - dims / 2
    c, s = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    gx = local[..., 0] * c - local[..., 1] * s
    gy = local[..., 0] * s + local[..., 1] * c
    return torch.stack([gx + rois[..., None, 0], gy + rois[..., None, 1],
                        local[..., 2] + rois[..., None, 2]], dim=-1)


class RCNNHead(nn.Module):
    """Shared FCs (256, 256; BN, ReLU) over each RoI's flattened grid
    features -> (cls (B, R), reg (B, R, 7)), f32."""

    def __init__(self, in_channels: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        for i in range(2):
            setattr(self, f"fc{i}", nn.Linear(in_channels if i == 0 else 256, 256, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm1d(256, eps=1e-5, momentum=0.1))
        self.cls = nn.Linear(256, 1)
        self.reg = nn.Linear(256, 7)

    def forward(self, pooled):
        dt = compute_dtype(self.dtype)
        h = pooled.flatten(2)
        for i in range(2):
            h = torch.relu(batch_norm(linear(h, getattr(self, f"fc{i}"), dt),
                                      getattr(self, f"bn{i}"), dt))
        return linear(h, self.cls, dt).float()[..., 0], linear(h, self.reg, dt).float()


def generate_proposals(cls_scores, labels, boxes, num_rois: int, nms_thresh: float,
                       pre_top: int = 512):
    """Each frame's top ``pre_top`` of (B, N) max-class scores, rotated NMS
    at ``nms_thresh`` (one ``hgsfusion::nms_lazy`` call for the batch), the
    first ``num_rois`` kept in score order: (rois (B, num_rois, 7), scores,
    labels, valid), zeros where not valid."""
    k = min(pre_top, cls_scores.shape[-1])
    top_s, top_i = top_scores(cls_scores, k)
    top_b = torch.take_along_dim(boxes, top_i[..., None], dim=1)
    idx, valid = kept_slots(top_s, top_b, top_i, nms_thresh, num_rois)
    zero = torch.zeros((), device=boxes.device)
    rois = torch.where(valid[..., None], torch.take_along_dim(boxes, idx[..., None], dim=1), zero)
    scores = torch.where(valid, torch.take_along_dim(cls_scores, idx, dim=1), zero)
    out_labels = torch.where(valid, torch.take_along_dim(labels, idx, dim=1),
                             torch.zeros((), dtype=labels.dtype, device=labels.device))
    return rois, scores, out_labels, valid


def roi_targets(rois, roi_valid, gt_boxes, fg_thresh: float = 0.55, cls_lo: float = 0.25,
                cls_hi: float = 0.75):
    """Each RoI's targets in its own order, for (B, R, 7) RoIs and (B, M, 8)
    gt boxes: ``cls_labels`` (its best 3-D IoU with a real gt box mapped to
    [0, 1]), ``cls_valid``, ``reg_valid`` (IoU >= ``fg_thresh``),
    ``gt_of_roi`` (the best box, the first on ties) and ``iou``."""
    out = {"cls_labels": [], "reg_valid": [], "gt_of_roi": [], "iou": []}
    for f in range(rois.shape[0]):
        gt = gt_boxes[f]
        iou = boxes_iou3d(rois[f, :, :7], gt[:, :7])
        iou = torch.where((gt[:, -1] > 0)[None, :] & roi_valid[f][:, None], iou,
                          torch.full_like(iou, -1.0))
        max_iou = torch.clamp(iou.max(dim=1).values, min=0.0)
        matched = iou.argmax(dim=1)
        out["cls_labels"].append(torch.clamp((max_iou - cls_lo) / (cls_hi - cls_lo), 0.0, 1.0))
        out["reg_valid"].append((max_iou >= fg_thresh) & roi_valid[f])
        out["gt_of_roi"].append(gt[matched])
        out["iou"].append(max_iou)
    return {**{k: torch.stack(v) for k, v in out.items()}, "cls_valid": roi_valid}


def _roi_anchors(rois):
    """RoI-sized anchors at the origin, sizes clamped to 1e-3."""
    return torch.cat([torch.zeros_like(rois[..., :3]), torch.clamp(rois[..., 3:6], min=1e-3),
                      torch.zeros_like(rois[..., 6:7])], dim=-1)


def canonical_reg_targets(rois, gt_boxes, coder):
    """The gt box in its RoI's frame (centre rotated by -heading, heading
    difference wrapped to [0, 2 pi), opposite ones flipped by pi, then
    mapped into [-pi/2, pi/2]), encoded against the RoI-sized anchor at the
    origin."""
    rel = gt_boxes[..., :3] - rois[..., :3]
    c, s = torch.cos(-rois[..., 6]), torch.sin(-rois[..., 6])
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    heading = torch.remainder(gt_boxes[..., 6] - rois[..., 6], 2 * math.pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + math.pi, 2 * math.pi), heading)
    heading = torch.where(heading > math.pi, heading - 2 * math.pi, heading)
    heading = torch.clamp(heading, -math.pi / 2, math.pi / 2)
    gt_ct = torch.cat([lx[..., None], ly[..., None], rel[..., 2:3],
                       torch.clamp(gt_boxes[..., 3:6], min=1e-3), heading[..., None]], dim=-1)
    return coder.encode(gt_ct, _roi_anchors(rois))


def decode_canonical(reg, rois, coder):
    """``canonical_reg_targets``' inverse: residuals -> global boxes."""
    local = coder.decode(reg, _roi_anchors(rois))
    c, s = torch.cos(rois[..., 6]), torch.sin(rois[..., 6])
    gx = local[..., 0] * c - local[..., 1] * s + rois[..., 0]
    gy = local[..., 0] * s + local[..., 1] * c + rois[..., 1]
    return torch.cat([gx[..., None], gy[..., None], (local[..., 2] + rois[..., 2])[..., None],
                      local[..., 3:6], local[..., 6:7] + rois[..., 6:7]], dim=-1)


def soft_label_bce(logits, targets: Dict):
    """BCE of sigmoid(logits), clamped to [1e-6, 1 - 1e-6], against the
    RoIs' soft labels, averaged over the valid RoIs."""
    cls_t = targets["cls_labels"]
    cv = targets["cls_valid"].to(torch.float32)
    p = torch.clamp(torch.sigmoid(logits), 1e-6, 1 - 1e-6)
    bce = -(cls_t * torch.log(p) + (1 - cls_t) * torch.log(1 - p))
    return (bce * cv).sum() / torch.clamp(cv.sum(), min=1.0)


def rcnn_losses(rcnn_cls, rcnn_reg, targets: Dict, rois, coder, cls_weight: float = 1.0,
                reg_weight: float = 1.0, code_weights: Sequence[float] = (1.0,) * 7):
    """BCE on the RoIs' soft IoU labels + smooth-L1 (beta 1/9) on the
    canonical residuals of the foreground RoIs: (total, {"rcnn_cls",
    "rcnn_reg"})."""
    loss_cls = soft_label_bce(rcnn_cls, targets)
    reg_t = canonical_reg_targets(rois, targets["gt_of_roi"][..., :7], coder)
    rv = targets["reg_valid"].to(torch.float32)
    sl1 = weighted_smooth_l1(rcnn_reg, reg_t, rv, code_weights=code_weights)
    loss_reg = sl1.sum() / torch.clamp(rv.sum(), min=1.0)
    return (loss_cls * cls_weight + loss_reg * reg_weight,
            {"rcnn_cls": loss_cls, "rcnn_reg": loss_reg})
