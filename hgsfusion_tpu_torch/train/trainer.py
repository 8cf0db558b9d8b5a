"""The training step (counterpart of ``hgsfusion_tpu/train/trainer.py``:
model_inputs, _grad_step, make_train_step, make_anchor_assigner,
make_multihead_train_step, make_transfusion_train_step,
make_center_train_step, make_twostage_train_step, and the family dispatch
of ``tools/train.py`` as ``make_train_step_for_cfg``), and the detections
of ``serve`` as per-frame numpy dicts (detections_to_pred_dicts).

One step is the forward pass in train mode, target assignment, the RPN
losses (and, where the model predicts occupancy, the occupancy loss; under
USE_DEPTH with depth maps in the batch, the DDN depth loss), the backward
pass and the optimizer's update. The multi-head family's step takes its
grouped loss instead, the TransFusion families' (BEVFusion, TransFusion-L)
their Hungarian-matched set loss, the CenterHead families' (CenterPoint,
VoxelNeXt) the heatmap focal loss and the L1 at the gt centers; SECOND's is
the anchor step with its stride-8 anchors (the focal SECOND's adds its
backbone's importance loss), Voxel R-CNN's, SECOND-IoU's, PV-RCNN's and
PV-RCNN++'s and Part-A2's the anchor losses and their second stage's
(``make_twostage_train_step``; PV-RCNN's with the keypoints' foreground
loss, Part-A2's with its point part head's). PyTorch
runs it eagerly; nothing in it reads a tensor back to the host but the
TransFusion step's matching costs (one read a step,
``models/transfusion_head.py``). Evaluation needs no dispatch here: every
family's ``serve`` runs its own post-processing (the JAX package's
``make_transfusion_eval_step`` is the TransFusion families'
``post_process``, its ``make_center_eval_step`` the CenterHead families',
``models/detector.py::center_post_process``, its
``make_pvrcnn_eval_step`` Voxel R-CNN's, PV-RCNN's, PV-RCNN++'s and Part-A2's,
``refine_post_process``, and its
``make_secondiou_eval_step`` SECOND-IoU's).

Under ``DistributedDataParallel`` (``parallel/mesh.py``) the forward goes
through the wrapper, whose hooks average the gradients of ``backward`` over
the ranks. The losses are per-frame means (the anchor head
normalizes each frame and divides by the batch, the occupancy loss is a
mean over equal-sized frames), so with equal per-rank batches the average
is the global batch's gradient, and the step reports the loss terms
averaged over the ranks: the global batch's.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..models.anchor_head import anchor_head_loss, anchor_head_multi_loss
from ..models.anchors import TargetAssigner
from ..models.center_head import center_head_loss, center_targets
from ..models.ddn_loss import ddn_loss
from ..models.detector import (BATCH_KEYS, BEVFusionModel, CenterPointModel, PartA2Model,
                               PointPillarMultiHeadModel, PVRCNNModel, PVRCNNPlusPlusModel,
                               SECONDIoUModel, TransFusionModel, VoxelNeXtModel, VoxelRCNNModel,
                               make_multihead_assigner)
from ..models.focal_conv import focal_conv_loss
from ..models.occupancy import occupancy_loss
from ..models.parta2 import part_head_loss, part_targets
from ..models.pvrcnn import point_fg_loss, rcnn_losses, roi_targets
from ..models.roi_heads import iou_head_loss
from ..models.transfusion_head import transfusion_loss
from ..parallel.mesh import all_reduce_mean_
from ..utils.box_coder import ResidualCoder


def model_inputs(batch: Dict) -> Dict:
    """The batch keys the model and its losses read."""
    return {k: batch[k] for k in BATCH_KEYS if k in batch}


def _grad_step(loss_fn, optimizer) -> Callable:
    """loss_fn(batch) -> (loss, tb), then ``backward`` (under DDP its hooks
    average the gradients over the ranks as they become ready), then one
    update from the parameters' gradients (None reads as 0). The step
    returns (loss, tb), detached, the terms averaged over the ranks in one
    all-reduce (no collective without a group)."""

    def step(batch):
        loss, tb = loss_fn(batch)
        loss.backward()
        optimizer.step([p.grad for p in optimizer.params])
        for p in optimizer.params:
            p.grad = None
        keys = sorted(tb)
        flat = all_reduce_mean_(torch.stack([tb[k].detach().float() for k in keys]))
        tb = dict(zip(keys, flat.unbind()))
        return tb["loss"], tb

    return step


# the occupancy target's footprint bound (voxels per axis) that the JAX
# package's make_train_step passes (occupancy_loss defaults to 32)
OCC_MAX_HALF_EXTENT = 48


def make_train_step(model, assigner: TargetAssigner, optimizer, loss_weights: Dict,
                    cfg, ddp=None) -> Callable:
    """One training step: loss = rpn (cls + loc + dir) (+ the occupancy focal
    loss where the model predicts occupancy, + the DDN loss where it gives
    depth logits and the batch has ``depth_maps``). ``batch`` holds tensors on the model's device,
    ``gt_boxes`` (B, M, 8) among them; tb keys rpn_loss_cls, rpn_loss_loc,
    rpn_loss_dir, rpn_loss, (loss_occ,) loss (and ddn_loss, fg_loss, bg_loss).
    Puts ``model`` in train mode. ``ddp``: ``model`` under
    ``DistributedDataParallel`` (``parallel.mesh.wrap_model``), which then
    runs the forward pass."""
    anchors = assigner.flat_anchors
    net = model if ddp is None else ddp

    def loss_fn(batch):
        net.train()
        preds = net(model_inputs(batch))
        targets = assigner(batch["gt_boxes"])
        total, tb = anchor_head_loss(preds, targets, anchors, cfg.num_class, loss_weights,
                                     dir_offset=cfg.dir_offset, num_dir_bins=cfg.num_dir_bins)
        if "occupancy" in preds:
            occ = occupancy_loss(preds["occupancy"], batch["gt_boxes"], cfg.grid_size,
                                 cfg.pc_range, cfg.voxel_size, OCC_MAX_HALF_EXTENT)
            total = total + occ
            tb = {**tb, "loss_occ": occ}
        if "depth_logits" in preds and "depth_maps" in batch:
            # as the JAX package calls it: 2-D boxes (B, N, 4), zeros when the
            # batch has none, and downsample_factor 1 although the boxes are
            # in image pixels and the logits at 1/4 of them (ROADMAP queue 3)
            boxes2d = batch.get("gt_boxes2d")
            if boxes2d is None:
                boxes2d = preds["depth_logits"].new_zeros((batch["gt_boxes"].shape[0], 1, 4))
            dloss, dtb = ddn_loss(preds["depth_logits"], batch["depth_maps"], boxes2d,
                                  cfg.disc_cfg)
            tb = {**tb, **dtb}
            total = total + dloss
        total, tb = _add_focal_loss(preds, batch, cfg, total, tb)
        return total, {**tb, "loss": total}

    return _grad_step(loss_fn, optimizer)


def _add_focal_loss(preds, batch, cfg, total, tb):
    """The focal backbone's importance loss (``loss_box_of_pts``), added
    unweighted where the model gives ``focal_aux``."""
    if "focal_aux" not in preds:
        return total, tb
    fl = focal_conv_loss(preds["focal_aux"], batch["gt_boxes"], cfg.pc_range, cfg.voxel_size)
    return total + fl, {**tb, "loss_box_of_pts": fl}


def make_twostage_train_step(model, assigner: TargetAssigner, optimizer, loss_weights: Dict,
                             cfg, family: str, ddp=None) -> Callable:
    """The anchor-RPN two-stage families' step: the RPN's anchor losses,
    "pvrcnn" and "pvrcnnpp" the keypoints' ``point_fg_loss`` (tb key
    point_fg), "parta2" the point part head's ``part_head_loss`` of its
    ``part_targets`` (part_cls, part_reg), the focal backbone's loss where
    it has one, then the second stage against each proposal's
    ``roi_targets``: "voxelrcnn", "pvrcnn", "pvrcnnpp" and "parta2"
    ``rcnn_losses`` (tb keys rcnn_cls, rcnn_reg), "secondiou"
    ``iou_head_loss`` (rcnn_iou). The JAX package's other family,
    "pointrcnn", raises, naming its ROADMAP.md entry."""
    if family == "pointrcnn":
        raise NotImplementedError("the pointrcnn two-stage step is not ported (ROADMAP.md "
                                  "queue 1 item 9 (c7))")
    if family not in ("voxelrcnn", "secondiou", "pvrcnn", "pvrcnnpp", "parta2"):
        raise ValueError(f"unknown two-stage family {family!r}")
    anchors = assigner.flat_anchors
    coder = ResidualCoder()
    net = model if ddp is None else ddp

    def loss_fn(batch):
        net.train()
        preds = net(model_inputs(batch))
        targets = assigner(batch["gt_boxes"])
        total, tb = anchor_head_loss(preds, targets, anchors, cfg.num_class, loss_weights,
                                     dir_offset=cfg.dir_offset, num_dir_bins=cfg.num_dir_bins)
        if family in ("pvrcnn", "pvrcnnpp"):
            pt = point_fg_loss(preds["point_logits"], preds["keypoints"], batch["gt_boxes"])
            total, tb = total + pt, {**tb, "point_fg": pt}
        elif family == "parta2":
            pt = part_targets(batch["points"][..., :3], batch["points_valid"], batch["gt_boxes"])
            pl, ptb = part_head_loss(preds["seg_logits"], preds["part_pred"], pt)
            total, tb = total + pl, {**tb, **ptb}
        total, tb = _add_focal_loss(preds, batch, cfg, total, tb)
        rt = roi_targets(preds["rois"], preds["roi_valid"], batch["gt_boxes"])
        if family == "secondiou":
            il = iou_head_loss(preds["iou_preds"], rt)
            total, tb = total + il, {**tb, "rcnn_iou": il}
        else:
            rl, rtb = rcnn_losses(preds["rcnn_cls"], preds["rcnn_reg"], rt, preds["rois"], coder)
            total, tb = total + rl, {**tb, **rtb}
        return total, {**tb, "loss": total}

    return _grad_step(loss_fn, optimizer)


def make_multihead_train_step(model, assigner: TargetAssigner, optimizer, loss_weights: Dict,
                              cfg, ddp=None) -> Callable:
    """The AnchorHeadMulti family's step: ``anchor_head_multi_loss`` over
    the per-head slices of the multi-head anchor order; tb keys
    rpn_loss_cls, rpn_loss_loc (rpn_loss_dir), rpn_loss, loss."""
    net = model if ddp is None else ddp
    s = assigner.anchor_shapes[0]
    grid_hw = int(s[0] * s[1] * s[2])

    def loss_fn(batch):
        net.train()
        preds = net(model_inputs(batch))
        targets = assigner(batch["gt_boxes"])
        total, tb = anchor_head_multi_loss(
            preds, targets, assigner, loss_weights, cfg.rpn_head_cfgs, grid_hw,
            dir_offset=cfg.dir_offset, num_dir_bins=cfg.num_dir_bins,
            separate_multihead=cfg.mh_separate_multihead)
        return total, {**tb, "loss": total}

    return _grad_step(loss_fn, optimizer)


def make_transfusion_train_step(model, optimizer, loss_weights: Dict, cfg, ddp=None) -> Callable:
    """The TransFusion families' step: ``transfusion_loss`` (the dense
    heatmap's gaussian focal loss, the Hungarian-matched proposals' class
    and box losses) at the head's map, ``grid_size`` / FEATURE_MAP_STRIDE;
    tb keys loss_heatmap, loss_cls_trans, loss_bbox, matched_ious, loss."""
    gx, gy, _ = cfg.grid_size
    stride = cfg.center_feature_map_stride
    net = model if ddp is None else ddp

    def loss_fn(batch):
        net.train()
        preds = net(model_inputs(batch))
        total, tb = transfusion_loss(
            preds, batch["gt_boxes"], cfg.num_class, cfg.pc_range, cfg.voxel_size, stride,
            (gy // stride, gx // stride), cls_weight=loss_weights.get("cls_weight", 1.0),
            bbox_weight=loss_weights.get("bbox_weight", 0.25),
            hm_weight=loss_weights.get("hm_weight", 1.0),
            code_weights=loss_weights.get("code_weights", (1.0,) * 8),
            gaussian_overlap=cfg.center_gaussian_overlap, min_radius=cfg.center_min_radius)
        return total, {**tb, "loss": total}

    return _grad_step(loss_fn, optimizer)


def make_center_train_step(model, optimizer, loss_weights: Dict, cfg, ddp=None) -> Callable:
    """The CenterHead families' step: ``center_targets`` at the head's map
    (``grid_size`` / FEATURE_MAP_STRIDE; code size the sum of the head's
    regression widths: 8, or 10 with ``vel``), then ``center_head_loss``
    with LOSS_WEIGHTS' ``code_weights`` (default 1), ``cls_weight`` and
    ``loc_weight``; tb keys hm_loss, loc_loss_center, loss."""
    gx, gy, _ = cfg.grid_size
    stride = cfg.center_feature_map_stride
    fmap_hw = (gy // stride, gx // stride)
    head_order = tuple(cfg.center_head_order)
    code_size = int(sum(cfg.center_head_channels))
    code_weights = loss_weights.get("code_weights", (1.0,) * code_size)
    net = model if ddp is None else ddp

    def loss_fn(batch):
        net.train()
        preds = net(model_inputs(batch))
        targets = center_targets(batch["gt_boxes"], cfg.num_class, fmap_hw, stride, cfg.pc_range,
                                 cfg.voxel_size, gaussian_overlap=cfg.center_gaussian_overlap,
                                 min_radius=cfg.center_min_radius, code_size=code_size)
        total, tb = center_head_loss(preds, targets, head_order, code_weights,
                                     cls_weight=loss_weights.get("cls_weight", 1.0),
                                     loc_weight=loss_weights.get("loc_weight", 2.0))
        return total, {**tb, "loss": total}

    return _grad_step(loss_fn, optimizer)


def make_anchor_assigner(model_cfg, multihead: bool, device="cuda") -> TargetAssigner:
    """The target assigner of a family: the multi-head anchor order and the
    config's box coder for AnchorHeadMulti, else the single-head one."""
    if multihead:
        return make_multihead_assigner(model_cfg, device=device)
    return TargetAssigner(model_cfg.anchor_generator, model_cfg.grid_size, model_cfg.pc_range,
                          model_cfg.class_names, device=device)


def make_train_step_for_cfg(model, optimizer, model_cfg, ddp=None):
    """The family's training step for ``model`` (``models/registry.py``'s
    build): the TransFusion step for BEVFusionModel and TransFusionModel,
    the center step for CenterPointModel and VoxelNeXtModel (no assigner:
    None), the multi-head step for PointPillarMultiHeadModel, the two-stage
    step for VoxelRCNNModel, SECONDIoUModel, PVRCNNModel,
    PVRCNNPlusPlusModel and PartA2Model, else ``make_train_step``
    (SECONDModel's, the focal one's included). Returns (assigner, step)."""
    if isinstance(model, (BEVFusionModel, TransFusionModel)):
        return None, make_transfusion_train_step(model, optimizer, model_cfg.loss_weights,
                                                 model_cfg, ddp=ddp)
    if isinstance(model, (CenterPointModel, VoxelNeXtModel)):
        return None, make_center_train_step(model, optimizer, model_cfg.loss_weights, model_cfg,
                                            ddp=ddp)
    multihead = isinstance(model, PointPillarMultiHeadModel)
    assigner = make_anchor_assigner(model_cfg, multihead, device=model.device)
    twostage = ((PVRCNNPlusPlusModel, "pvrcnnpp"), (PVRCNNModel, "pvrcnn"),
                (VoxelRCNNModel, "voxelrcnn"), (SECONDIoUModel, "secondiou"),
                (PartA2Model, "parta2"))
    family = next((f for cls, f in twostage if isinstance(model, cls)), None)
    if family is not None:
        return assigner, make_twostage_train_step(model, assigner, optimizer,
                                                  model_cfg.loss_weights, model_cfg, family,
                                                  ddp=ddp)
    make = make_multihead_train_step if multihead else make_train_step
    return assigner, make(model, assigner, optimizer, model_cfg.loss_weights, model_cfg, ddp=ddp)


def detections_to_pred_dicts(out: Dict) -> list:
    """``serve``'s fixed-shape detections -> one dict of numpy arrays per
    frame, its valid rows only: pred_boxes (N, 7) (N, 9 with the velocities
    of a multi-head model's ``vels``), pred_scores (N,), pred_labels (N,)
    int64. Reads the batch back to the host once."""
    host = {k: out[k].cpu().numpy() for k in ("boxes", "scores", "labels", "valid")}
    if "vels" in out:
        host["boxes"] = np.concatenate([host["boxes"], out["vels"].cpu().numpy()], axis=-1)
    return [{"pred_boxes": host["boxes"][i][m], "pred_scores": host["scores"][i][m],
             "pred_labels": host["labels"][i][m].astype(np.int64)}
            for i, m in enumerate(host["valid"])]
