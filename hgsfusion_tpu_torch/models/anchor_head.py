"""Anchor heads: 1x1 cls / box / dir convs, the selected-box decode and the
RPN losses, and the grouped multi-head head of the nuScenes configs.

Counterpart of ``hgsfusion_tpu/models/anchor_head.py`` (AnchorHeadSingle,
decode_selected_boxes, sigmoid_focal_loss, weighted_smooth_l1,
weighted_cross_entropy, add_sin_difference, get_direction_target,
anchor_head_loss; SingleRPNHead, AnchorHeadMulti, multihead_anchor_slices,
anchor_head_multi_loss, generate_predicted_boxes_multihead).
AnchorHeadSingle runs in float32, as the JAX module has no compute dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.common import device_constant, limit_period
from .layers import batch_norm, compute_dtype, conv_nhwc


class AnchorHeadSingle(nn.Module):
    """Outputs (NHWC): cls (B, ny, nx, A*num_class), box (B, ny, nx,
    A*code_size), dir (B, ny, nx, A*num_dir_bins)."""

    def __init__(self, in_channels: int, num_class: int = 3,
                 num_anchors_per_location: int = 6, code_size: int = 7,
                 num_dir_bins: int = 2):
        super().__init__()
        a = num_anchors_per_location
        self.conv_cls = nn.Conv2d(in_channels, a * num_class, 1)
        self.conv_box = nn.Conv2d(in_channels, a * code_size, 1)
        self.conv_dir_cls = nn.Conv2d(in_channels, a * num_dir_bins, 1)

    def forward(self, spatial_features_2d):
        x = spatial_features_2d
        return {
            "cls_preds": conv_nhwc(x, self.conv_cls, torch.float32),
            "box_preds": conv_nhwc(x, self.conv_box, torch.float32),
            "dir_cls_preds": conv_nhwc(x, self.conv_dir_cls, torch.float32),
        }


def decode_selected_boxes(box_rows, dir_rows, anchor_rows, box_coder,
                          dir_offset: float = 0.78539,
                          dir_limit_offset: float = 0.0, num_dir_bins: int = 2):
    """Box decode + direction-bin heading correction of pre-selected anchor
    rows (any leading shape)."""
    dec = box_coder.decode(box_rows, anchor_rows)
    if dir_rows is None:
        return dec
    dir_labels = torch.argmax(dir_rows, dim=-1)
    period = 2 * math.pi / num_dir_bins
    dir_rot = limit_period(dec[..., 6] - dir_offset, dir_limit_offset, period)
    heading = dir_rot + dir_offset + period * dir_labels.to(dec.dtype)
    return torch.cat([dec[..., :6], heading[..., None]], dim=-1)


def sigmoid_focal_loss(logits, one_hot_targets, weights, alpha: float = 0.25,
                       gamma: float = 2.0):
    """Per-element sigmoid focal loss x anchor weights."""
    pred_sigmoid = torch.sigmoid(logits)
    alpha_weight = one_hot_targets * alpha + (1 - one_hot_targets) * (1 - alpha)
    pt = one_hot_targets * (1.0 - pred_sigmoid) + (1.0 - one_hot_targets) * pred_sigmoid
    focal_weight = alpha_weight * torch.pow(pt, gamma)
    bce = (torch.clamp(logits, min=0) - logits * one_hot_targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return focal_weight * bce * weights[..., None]


def weighted_smooth_l1(pred, target, weights, code_weights=None, beta: float = 1.0 / 9.0):
    """Code-weighted smooth-L1 x anchor weights; a NaN target takes the
    prediction (zero loss)."""
    target = torch.where(torch.isnan(target), pred, target)
    diff = pred - target
    if code_weights is not None:
        diff = diff * device_constant(tuple(code_weights), diff.dtype, diff.device)
    n = torch.abs(diff)
    loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    return loss * weights[..., None]


def weighted_cross_entropy(logits, one_hot_targets, weights):
    """Cross entropy over the last axis x anchor weights."""
    return -torch.sum(one_hot_targets * F.log_softmax(logits, dim=-1), dim=-1) * weights


def add_sin_difference(boxes1, boxes2, dim: int = 6):
    """The angle residual as sin(a - b) = sin a cos b - cos a sin b, split
    between the two boxes."""
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return b1, b2


def get_direction_target(anchors, reg_targets, dir_offset: float, num_bins: int):
    """One-hot direction-bin targets."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    dir_cls = torch.floor(offset_rot / (2 * math.pi / num_bins)).long()
    dir_cls = torch.clamp(dir_cls, 0, num_bins - 1)
    return F.one_hot(dir_cls, num_bins).to(reg_targets.dtype)


def anchor_head_loss(preds, targets, anchors, num_class: int, loss_weights: dict,
                     dir_offset: float = 0.78539, num_dir_bins: int = 2):
    """Total RPN loss (cls + loc + dir) -> (loss, tb) with tb keys
    rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss. preds: NHWC head
    outputs; targets: TargetAssigner output; anchors (A, 7) flat."""
    cls_preds, box_preds = preds["cls_preds"], preds["box_preds"]
    dir_preds = preds.get("dir_cls_preds")
    b = cls_preds.shape[0]
    box_cls_labels = targets["box_cls_labels"]
    box_reg_targets = targets["box_reg_targets"]

    cared = box_cls_labels >= 0
    positives = box_cls_labels > 0
    negatives = box_cls_labels == 0
    cls_weights = (negatives * 1.0 + positives * 1.0).to(torch.float32)
    reg_weights = positives.to(torch.float32)
    pos_normalizer = torch.clamp(positives.sum(dim=1, keepdim=True).to(torch.float32), min=1.0)
    reg_weights = reg_weights / pos_normalizer
    cls_weights = cls_weights / pos_normalizer

    cls_targets = torch.where(cared, box_cls_labels, torch.zeros_like(box_cls_labels))
    one_hot = F.one_hot(cls_targets.long(), num_class + 1).to(cls_preds.dtype)[..., 1:]
    cls_loss = (torch.sum(sigmoid_focal_loss(cls_preds.reshape(b, -1, num_class), one_hot,
                                             cls_weights)) / b) * loss_weights["cls_weight"]

    box_preds_sin, reg_targets_sin = add_sin_difference(
        box_preds.reshape(b, anchors.shape[0], -1), box_reg_targets)
    loc_loss = (torch.sum(weighted_smooth_l1(
        box_preds_sin, reg_targets_sin, reg_weights,
        code_weights=loss_weights.get("code_weights"))) / b) * loss_weights["loc_weight"]

    tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    total = cls_loss + loc_loss
    if dir_preds is not None:
        anchors_b = anchors[None].expand((b,) + anchors.shape)
        dir_targets = get_direction_target(anchors_b, box_reg_targets, dir_offset, num_dir_bins)
        dir_logits = dir_preds.reshape(b, anchors.shape[0], num_dir_bins)
        weights = positives.to(torch.float32)
        weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1.0)
        dir_loss = (torch.sum(weighted_cross_entropy(dir_logits, dir_targets, weights)) / b
                    ) * loss_weights["dir_weight"]
        tb["rpn_loss_dir"] = dir_loss
        total = total + dir_loss
    tb["rpn_loss"] = total
    return total, tb


# ---------------------------------------------------------------------------
# AnchorHeadMulti: the grouped multi-head anchor head of the nuScenes configs
# ---------------------------------------------------------------------------

class SingleRPNHead(nn.Module):
    """One class group's head: per output part (cls and each entry of the
    separate-reg list) ``num_middle_conv`` 3x3 conv-BN-ReLU layers (BN eps
    1e-5, momentum 0.1, f32) and a 3x3 conv with bias; an optional 1x1
    direction conv on the head's input. The parts' channels are
    concatenated part-major and then read anchor-major, as the reference's
    ``.view(-1, A, code, H, W)`` reads them; train and decode share that
    order. Outputs (B, A*H*W, F) f32 rows, anchor-major. Parameters take the
    JAX package's names (``{part}_mid{k}_conv`` / ``_bn``, ``conv_cls``,
    ``conv_{name}``, ``conv_dir_cls``)."""

    def __init__(self, in_channels: int, num_class: int, num_anchors_per_location: int,
                 code_size: int, separate_reg_list, num_middle_conv: int = 1,
                 num_middle_filter: int = 64, num_dir_bins: int = 2, use_dir: bool = False,
                 dtype=None):
        super().__init__()
        a = num_anchors_per_location
        self.a, self.num_class, self.code_size = a, num_class, code_size
        self.num_dir_bins, self.use_dir, self.dtype = num_dir_bins, use_dir, dtype
        self.num_middle_conv = num_middle_conv
        self.parts = [tuple(r.split(":")) for r in separate_reg_list]
        for prefix in ["cls"] + [f"reg_{name}" for name, _ in self.parts]:
            cin = in_channels
            for k in range(num_middle_conv):
                setattr(self, f"{prefix}_mid{k}_conv",
                        nn.Conv2d(cin, num_middle_filter, 3, 1, 1, bias=False))
                setattr(self, f"{prefix}_mid{k}_bn", nn.BatchNorm2d(num_middle_filter))
                cin = num_middle_filter
        mid = num_middle_filter if num_middle_conv else in_channels
        self.conv_cls = nn.Conv2d(mid, a * num_class, 3, 1, 1)
        for name, ch in self.parts:
            setattr(self, f"conv_{name}", nn.Conv2d(mid, a * int(ch), 3, 1, 1))
        if use_dir:
            self.conv_dir_cls = nn.Conv2d(in_channels, a * num_dir_bins, 1)

    def _middle(self, x, prefix):
        dt = compute_dtype(self.dtype)
        for k in range(self.num_middle_conv):
            y = conv_nhwc(x, getattr(self, f"{prefix}_mid{k}_conv"), dt)
            x = torch.relu(batch_norm(y, getattr(self, f"{prefix}_mid{k}_bn"), torch.float32))
        return x

    def _rows(self, x, per_anchor: int):
        """(B, H, W, A*F) -> (B, A*H*W, F), anchor-major."""
        b, h, w, _ = x.shape
        x = x.float().reshape(b, h, w, self.a, per_anchor).permute(0, 3, 1, 2, 4)
        return x.reshape(b, -1, per_anchor)

    def forward(self, feats):
        dt = compute_dtype(self.dtype)
        cls = conv_nhwc(self._middle(feats, "cls"), self.conv_cls, dt)
        box = torch.cat([conv_nhwc(self._middle(feats, f"reg_{name}"),
                                   getattr(self, f"conv_{name}"), dt)
                         for name, _ in self.parts], dim=-1)
        out = {"cls_preds": self._rows(cls, self.num_class),
               "box_preds": self._rows(box, self.code_size)}
        if self.use_dir:
            out["dir_cls_preds"] = self._rows(conv_nhwc(feats, self.conv_dir_cls, dt),
                                              self.num_dir_bins)
        return out


class AnchorHeadMulti(nn.Module):
    """A shared 3x3 conv-BN-ReLU (BN eps 1e-3, momentum 0.01, f32; named
    ``shared_conv`` / ``shared_bn``), then one ``SingleRPNHead`` per class
    group (``head_{i}``). Outputs per-head lists in the multi-head anchor
    order (``anchors.flatten_anchors_multihead``); without
    ``separate_multihead`` each head scores every class and the lists are
    concatenated."""

    def __init__(self, in_channels: int, class_names, rpn_head_cfgs, num_per_loc,
                 code_size: int = 10, shared_conv_filters: int = 64,
                 separate_reg_list=("reg:2", "height:1", "size:3", "angle:2", "velo:2"),
                 num_middle_conv: int = 1, num_middle_filter: int = 64, num_dir_bins: int = 2,
                 use_dir: bool = False, separate_multihead: bool = True, dtype=None):
        super().__init__()
        self.dtype, self.separate_multihead, self.use_dir = dtype, separate_multihead, use_dir
        self.shared = bool(shared_conv_filters)
        if self.shared:
            self.shared_conv = nn.Conv2d(in_channels, shared_conv_filters, 3, 1, 1, bias=False)
            self.shared_bn = nn.BatchNorm2d(shared_conv_filters, eps=1e-3, momentum=0.01)
            in_channels = shared_conv_filters
        names = list(class_names)
        self.num_heads = len(rpn_head_cfgs)
        for hi, head_cls in enumerate(rpn_head_cfgs):
            a = sum(num_per_loc[names.index(c)] for c in head_cls)
            nc = len(head_cls) if separate_multihead else len(names)
            setattr(self, f"head_{hi}", SingleRPNHead(
                in_channels, nc, a, code_size, separate_reg_list, num_middle_conv,
                num_middle_filter, num_dir_bins, use_dir, dtype))

    def forward(self, feats):
        if self.shared:
            y = conv_nhwc(feats, self.shared_conv, compute_dtype(self.dtype))
            feats = torch.relu(batch_norm(y, self.shared_bn, torch.float32))
        heads = [getattr(self, f"head_{hi}")(feats) for hi in range(self.num_heads)]
        out = {k: [h[k] for h in heads] for k in heads[0]}
        if not self.separate_multihead:
            out = {k: torch.cat(v, dim=1) for k, v in out.items()}
        return out


def multihead_anchor_slices(class_names, rpn_head_cfgs, num_per_loc, grid_hw: int):
    """Per head, its (start, stop) slice of the multi-head anchor axis and
    its classes' 1-based labels. A head's classes must be contiguous in
    CLASS_NAMES order (the reference's RPN_HEAD_CFGS convention)."""
    names = list(class_names)
    starts = np.concatenate([[0], np.cumsum([n * grid_hw for n in num_per_loc])])
    slices, label_idx = [], []
    for head_cls in rpn_head_cfgs:
        ids = [names.index(c) for c in head_cls]
        if ids != list(range(ids[0], ids[0] + len(ids))):
            raise ValueError(f"head classes {head_cls} are not contiguous in CLASS_NAMES")
        slices.append((int(starts[ids[0]]), int(starts[ids[-1] + 1])))
        label_idx.append([i + 1 for i in ids])
    return slices, label_idx


def anchor_head_multi_loss(preds, targets, assigner, loss_weights: dict, rpn_head_cfgs,
                           grid_hw: int, dir_offset: float = 0.78539, num_dir_bins: int = 2,
                           separate_multihead: bool = True):
    """The multi-head cls + reg (+ dir) loss over per-head slices of the
    multi-head anchor order -> (loss, tb) with tb keys rpn_loss_cls,
    rpn_loss_loc (rpn_loss_dir), rpn_loss. ``targets``: a
    ``TargetAssigner(use_multihead=True)``'s."""
    cls_preds, box_preds = preds["cls_preds"], preds["box_preds"]
    dir_preds = preds.get("dir_cls_preds")
    if not isinstance(cls_preds, (list, tuple)):
        cls_preds, box_preds = [cls_preds], [box_preds]
        dir_preds = None if dir_preds is None else [dir_preds]
    labels = targets["box_cls_labels"]
    reg_targets = targets["box_reg_targets"]
    b = labels.shape[0]
    num_class = len(assigner.class_names)
    pos, neg = labels > 0, labels == 0
    pos_norm = torch.clamp(pos.sum(dim=1, keepdim=True).to(torch.float32), min=1.0)
    cls_weights = (neg.to(torch.float32) + pos.to(torch.float32)) / pos_norm
    reg_weights = pos.to(torch.float32) / pos_norm
    cls_targets = torch.where(labels >= 0, labels, torch.zeros_like(labels))
    one_hot = F.one_hot(cls_targets.long(), num_class + 1).to(torch.float32)[..., 1:]
    slices, _ = multihead_anchor_slices(assigner.class_names, rpn_head_cfgs,
                                        assigner.num_per_loc, grid_hw)
    anchors = assigner.flat_anchors
    cls_loss = loc_loss = dir_loss = 0.0
    c_idx = 0
    for hi, (cp, bp) in enumerate(zip(cls_preds, box_preds)):
        s0, s1 = slices[hi]
        nc = cp.shape[-1]
        oh = one_hot[:, s0:s1]
        if separate_multihead:
            oh = oh[..., c_idx:c_idx + nc]
            c_idx += nc
        cls_loss = cls_loss + torch.sum(sigmoid_focal_loss(cp, oh, cls_weights[:, s0:s1])) / b
        rt = reg_targets[:, s0:s1]
        # the sin difference only with a direction head: with the sin-cos
        # code and none, column 6 is a cosine residual, not an angle
        bp_sin, rt_sin = add_sin_difference(bp, rt) if dir_preds is not None else (bp, rt)
        loc_loss = loc_loss + torch.sum(weighted_smooth_l1(
            bp_sin, rt_sin, reg_weights[:, s0:s1],
            code_weights=loss_weights.get("code_weights"))) / b
        if dir_preds is not None:
            dir_targets = get_direction_target(anchors[None, s0:s1].expand(b, -1, -1), rt,
                                               dir_offset, num_dir_bins)
            w = pos.to(torch.float32)
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
            dir_loss = dir_loss + torch.sum(weighted_cross_entropy(
                dir_preds[hi], dir_targets, w[:, s0:s1])) / b
    cls_loss = cls_loss * loss_weights["cls_weight"]
    loc_loss = loc_loss * loss_weights["loc_weight"]
    tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    total = cls_loss + loc_loss
    if dir_preds is not None:
        tb["rpn_loss_dir"] = dir_loss * loss_weights["dir_weight"]
        total = total + tb["rpn_loss_dir"]
    tb["rpn_loss"] = total
    return total, tb


def generate_predicted_boxes_multihead(preds, anchors, box_coder, class_names, rpn_head_cfgs,
                                       num_per_loc, dir_offset: float = 0.78539,
                                       dir_limit_offset: float = 0.0, num_dir_bins: int = 2):
    """Per head: its logits (B, A_h, nc_h), its decoded boxes (B, A_h, 7 + C)
    (the direction bin applied where the head predicts one) and its
    classes' 1-based labels. ``anchors``: the multi-head flat anchors."""
    grid_hw = anchors.shape[0] // sum(num_per_loc)
    slices, label_idx = multihead_anchor_slices(class_names, rpn_head_cfgs, num_per_loc, grid_hw)
    dir_preds = preds.get("dir_cls_preds")
    boxes_out = []
    for hi, bp in enumerate(preds["box_preds"]):
        s0, s1 = slices[hi]
        boxes = box_coder.decode(bp, anchors[None, s0:s1])
        if dir_preds is not None:
            dir_labels = torch.argmax(dir_preds[hi], dim=-1)
            period = 2 * math.pi / num_dir_bins
            dir_rot = limit_period(boxes[..., 6] - dir_offset, dir_limit_offset, period)
            heading = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
            boxes = torch.cat([boxes[..., :6], heading[..., None], boxes[..., 7:]], dim=-1)
        boxes_out.append(boxes)
    return list(preds["cls_preds"]), boxes_out, label_idx
