"""Anchor head: 1x1 cls / box / dir convs, the selected-box decode and the
RPN losses.

Counterpart of ``hgsfusion_tpu/models/anchor_head.py`` (AnchorHeadSingle,
decode_selected_boxes, sigmoid_focal_loss, weighted_smooth_l1,
weighted_cross_entropy, add_sin_difference, get_direction_target,
anchor_head_loss). The head runs in float32, as the JAX module has no
compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.common import device_constant, limit_period
from .layers import conv_nhwc


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
