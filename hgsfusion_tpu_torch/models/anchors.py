"""Dense grid anchors and the axis-aligned target assigner (counterpart of
``hgsfusion_tpu/models/anchors.py``: generate_anchors, flatten_anchors,
flatten_anchors_multihead, _assign_single_class, TargetAssigner). The anchors
are static, computed with numpy; the assignment runs on the anchors' device
with no host read."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..utils.box_coder import ResidualCoder
from ..utils.box_utils import boxes3d_nearest_bev_iou


def generate_anchors(anchor_configs: Sequence[dict], grid_size, pc_range):
    """Per-class anchors (nz=1, ny, nx, n_size, n_rot, 7) + anchors per
    location. align_center False: stride = extent / (grid - 1); anchor z =
    bottom height + h / 2. Shifts accumulate in float64, then cast, as
    torch.arange does in the reference."""
    all_anchors, num_per_loc = [], []
    for cfg in anchor_configs:
        sizes = np.asarray(cfg["anchor_sizes"], np.float32)
        rotations = np.asarray(cfg["anchor_rotations"], np.float32)
        heights = np.asarray(cfg["anchor_bottom_heights"], np.float32)
        stride = cfg.get("feature_map_stride", 1)
        gx = int(grid_size[0]) // stride
        gy = int(grid_size[1]) // stride
        num_per_loc.append(len(rotations) * len(sizes) * len(heights))
        if cfg.get("align_center", False):
            x_stride = (pc_range[3] - pc_range[0]) / gx
            y_stride = (pc_range[4] - pc_range[1]) / gy
            x_off, y_off = x_stride / 2, y_stride / 2
        else:
            x_stride = (pc_range[3] - pc_range[0]) / (gx - 1)
            y_stride = (pc_range[4] - pc_range[1]) / (gy - 1)
            x_off, y_off = 0.0, 0.0
        x_shifts = np.arange(pc_range[0] + x_off, pc_range[3] + 1e-5, x_stride).astype(np.float32)
        y_shifts = np.arange(pc_range[1] + y_off, pc_range[4] + 1e-5, y_stride).astype(np.float32)
        nx, ny, nz = len(x_shifts), len(y_shifts), len(heights)
        ns, nr = len(sizes), len(rotations)
        xg, yg, zg = np.meshgrid(x_shifts, y_shifts, heights, indexing="ij")
        centers = np.stack([xg, yg, zg], axis=-1)
        anchors = np.concatenate([
            np.broadcast_to(centers[:, :, :, None, None, :], (nx, ny, nz, ns, nr, 3)),
            np.broadcast_to(sizes[None, None, None, :, None, :], (nx, ny, nz, ns, nr, 3)),
            np.broadcast_to(rotations[None, None, None, None, :, None], (nx, ny, nz, ns, nr, 1)),
        ], axis=-1)
        anchors = np.transpose(anchors, (2, 1, 0, 3, 4, 5)).copy()  # (nz, ny, nx, ...)
        anchors[..., 2] += anchors[..., 5] / 2
        all_anchors.append(anchors.astype(np.float32))
    return all_anchors, num_per_loc


def flatten_anchors(all_anchors: List[np.ndarray]) -> np.ndarray:
    """Concat class anchor sets along the size axis, flatten to (A, 7):
    index = (((z*ny + y)*nx + x)*n_cls_sets + set)*n_rot + rot."""
    cat = np.concatenate(all_anchors, axis=-3)
    return cat.reshape(-1, cat.shape[-1])


def flatten_anchors_multihead(all_anchors: List[np.ndarray]) -> np.ndarray:
    """The multi-head anchor order: one block per class, anchor type major:
    within a block, index = (((size*n_rot + rot)*nz + z)*ny + y)*nx + x."""
    return np.concatenate([np.transpose(a, (3, 4, 0, 1, 2, 5)).reshape(-1, a.shape[-1])
                           for a in all_anchors], axis=0)


def _assign_single_class(anchors, gt_boxes, gt_mask, gt_classes, matched_thr: float,
                         unmatched_thr: float, box_coder: ResidualCoder):
    """Assign one class's anchors, batched over images.

    anchors (A, 7); gt_boxes (B, M, 7); gt_mask (B, M) bool (this class and
    valid); gt_classes (B, M) int. Returns labels (B, A) int32 (-1 ignored,
    0 background), bbox_targets (B, A, 7) and reg_weights (B, A). An anchor
    is positive at IoU >= matched_thr or as the best anchor of a gt (ties:
    every anchor at the gt's maximum); a gt with no overlap forces nothing,
    and an image without a gt of this class is all background. ``argmax``
    takes the first maximum, as ``jnp.argmax`` does.
    """
    iou = boxes3d_nearest_bev_iou(anchors, gt_boxes)  # (B, A, M)
    iou = torch.where(gt_mask[:, None, :], iou, torch.full_like(iou, -1.0))
    anchor_max, anchor_arg = iou.max(dim=2).values, torch.argmax(iou, dim=2)
    gt_max = iou.max(dim=1).values  # (B, M)
    force_gt = gt_mask & (gt_max > 0)
    force_anchor = ((iou == gt_max[:, None, :]) & force_gt[:, None, :]).any(dim=2)
    pos = anchor_max >= matched_thr
    bg = anchor_max < unmatched_thr
    cls_of_anchor = torch.gather(gt_classes, 1, anchor_arg).to(torch.int32)

    labels = torch.where(bg, 0, -1).to(torch.int32)
    labels = torch.where(pos | force_anchor, cls_of_anchor, labels)
    labels = torch.where(gt_mask.any(dim=1, keepdim=True), labels, torch.zeros_like(labels))

    fg = labels > 0
    matched = torch.gather(gt_boxes, 1, anchor_arg[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    targets = box_coder.encode(matched, anchors[None])
    targets = torch.where(fg[..., None], targets, torch.zeros_like(targets))
    return labels, targets, fg.to(torch.float32)


class TargetAssigner:
    """Axis-aligned target assigner over padded gt boxes, in the single-head
    anchor order (``flatten_anchors``) or, with ``use_multihead``, the
    multi-head one (``flatten_anchors_multihead``). The per-class thresholds
    come from each anchor config's ``matched_threshold`` /
    ``unmatched_threshold``. A ``box_coder`` wider than 7 (velocities,
    sin-cos) pads the anchors with zero columns to its width, as the
    reference's anchor generator does."""

    def __init__(self, anchor_configs, grid_size, pc_range, class_names,
                 box_coder: ResidualCoder | None = None, use_multihead: bool = False,
                 device="cuda"):
        self.class_names = list(class_names)
        self.box_coder = box_coder or ResidualCoder()
        self.anchor_configs = list(anchor_configs)
        self.use_multihead = use_multihead
        all_anchors, num_per_loc = generate_anchors(anchor_configs, grid_size, pc_range)
        pad = self.box_coder.code_size - 7
        if pad > 0:
            all_anchors = [np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), np.float32)], -1)
                           for a in all_anchors]
        self.num_per_loc = [int(n) for n in num_per_loc]
        self.per_class_anchors = [torch.from_numpy(a.reshape(-1, a.shape[-1])).to(device)
                                  for a in all_anchors]
        self.anchor_shapes = [a.shape for a in all_anchors]
        flat = flatten_anchors_multihead(all_anchors) if use_multihead \
            else flatten_anchors(all_anchors)
        self.flat_anchors = torch.from_numpy(flat).to(device)
        self.matched = [float(c["matched_threshold"]) for c in anchor_configs]
        self.unmatched = [float(c["unmatched_threshold"]) for c in anchor_configs]

    def __call__(self, gt_boxes):
        """gt_boxes (B, M, 8) padded (or (B, M, 10) with velocities), class id
        in the last column (0 = pad) -> {box_cls_labels (B, A),
        box_reg_targets (B, A, code_size), reg_weights (B, A)} in the flat
        anchor order."""
        gt7 = gt_boxes[..., :-1]
        gt_cls = gt_boxes[..., -1].to(torch.int32)
        b = gt_boxes.shape[0]
        labels_c, targets_c, weights_c = [], [], []
        for ci, anchors in enumerate(self.per_class_anchors):
            class_id = self.class_names.index(self.anchor_configs[ci]["class_name"]) + 1
            labels, targets, weights = _assign_single_class(
                anchors, gt7, gt_cls == class_id, gt_cls, self.matched[ci],
                self.unmatched[ci], self.box_coder)
            nz, ny, nx, ns, nr, _ = self.anchor_shapes[ci]
            if self.use_multihead:
                # one block per class, anchor type major
                def block(x):
                    x = x.reshape((b, nz, ny, nx, ns, nr) + x.shape[2:])
                    x = x.permute((0, 4, 5, 1, 2, 3) + tuple(range(6, x.dim())))
                    return x.reshape((b, -1) + x.shape[6:])
                labels_c.append(block(labels))
                targets_c.append(block(targets))
                weights_c.append(block(weights))
                continue
            # interleave the classes per location: (B, nz*ny*nx, ncls, ns*nr)
            labels_c.append(labels.reshape(b, nz * ny * nx, ns * nr))
            targets_c.append(targets.reshape(b, nz * ny * nx, ns * nr, targets.shape[-1]))
            weights_c.append(weights.reshape(b, nz * ny * nx, ns * nr))
        if self.use_multihead:
            return {"box_cls_labels": torch.cat(labels_c, dim=1),
                    "box_reg_targets": torch.cat(targets_c, dim=1),
                    "reg_weights": torch.cat(weights_c, dim=1)}
        return {
            "box_cls_labels": torch.cat(labels_c, dim=-1).reshape(b, -1),
            "box_reg_targets": torch.cat(targets_c, dim=-2).reshape(b, -1, targets_c[0].shape[-1]),
            "reg_weights": torch.cat(weights_c, dim=-1).reshape(b, -1),
        }
