"""The two-stage RoI pieces of the anchor-RPN families: the FC stack every
FC head is built on, set abstraction over grouped points, voxel stages as
point sets, the RoI grid, the RCNN head, the proposal layer, the RoI
targets and the second-stage losses; and
PV-RCNN's and PV-RCNN++'s own: the keypoints, the voxel set abstraction,
the keypoint weighting, VectorPool, the RoI-grid pool and the keypoints'
foreground loss.

Counterpart of ``hgsfusion_tpu/models/pvrcnn.py`` (``_GroupMLP``,
``SALayer``, ``_stage_point_set``, ``interpolate_bev``,
``VoxelSetAbstraction``, ``KeypointWeighting``,
``sample_keypoints_proposal_centric``, ``VectorPoolLocal``,
``generate_proposals``, ``roi_targets``, ``canonical_reg_targets``,
``decode_canonical``, ``roi_grid_points``, ``RoIGridPool``, ``RCNNHead``,
``rcnn_losses``, ``point_fg_loss``) and of
``hgsfusion_tpu/models/point_rcnn.py::_FCStack`` (``FCStack``). As there:

- everything is fixed-shape: the proposals are the top 512 RPN boxes by
  score (ties by index, ``ops/nms.py::top_scores``), rotated NMS at
  ``NMS_THRESH_TRAIN`` keeping the first ``NUM_ROIS`` (one
  ``hgsfusion::nms_lazy`` call a batch), zeros in the unfilled slots;
- every valid RoI trains: its classification target is its best 3-D IoU
  with a gt box mapped linearly from [0.25, 0.75] to [0, 1], and RoIs at
  IoU 0.55 or more regress the canonical residual of their gt box
  (no random sampling, no corner loss);
- the grouped MLP's train-mode BatchNorm takes its statistics over every
  grouped row, the empty groups' included, before they are masked;
- the keypoints are one masked farthest-point sampling a batch
  (``ops/pointnet2.py::farthest_point_sample``, the hand kernel
  ``csrc/fps.cu`` on the card), PV-RCNN++'s over the points near a valid
  proposal (one global FPS, not the reference's sectors);
- the voxel stages enter the set abstraction and VectorPool as cell-centre
  point sets through the windowed ball query (``stage_point_set``'s grid),
  the raw points and the keypoints through the dense one;
- VectorPool averages each ball's 32 slots per cell of a 3 x 3 x 3 grid
  over the ball (repeated fill slots counted, an empty ball zero) as one
  batched product with the slots' one-hot cells: a deterministic sum
  where JAX takes ``segment_sum``.

Parameter names are JAX's (``mlp_r{i}.fc{j}`` / ``bn{j}``; the RCNN head's
``fc0``, ``bn0``, ``fc1``, ``bn1``, ``cls``, ``reg``; the set abstraction's
``sa_raw``, ``sa_x_conv3``, ``sa_x_conv4`` or ``vp_*``, ``fusion_fc``,
``fusion_bn``; the keypoint weighting's ``fc0`` .. ``cls``; the RoI-grid
pool's ``pool`` or ``pool_vp``), as torch ``Linear`` and ``BatchNorm1d``
(flax momentum 0.9 is torch's 0.1).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.grid_sample import div_exact
from ..ops.nms import kept_slots, top_scores
from ..ops.pointnet2 import (ball_query, ball_query_grid, farthest_point_sample, grid_axes,
                             grid_centers, query_and_group)
from ..ops.points_in_boxes import points_in_boxes
from ..ops.rotated_iou import boxes_iou3d
from ..utils.common import device_constant
from .anchor_head import sigmoid_focal_loss, weighted_smooth_l1
from .layers import batch_norm, compute_dtype


def linear(x, fc: nn.Linear, dtype):
    """``fc`` applied in ``dtype`` (a flax ``Dense`` of that dtype)."""
    return F.linear(x.to(dtype), fc.weight.to(dtype), None if fc.bias is None
                    else fc.bias.to(dtype))


class FCStack(nn.Module):
    """Linear without bias (``fc{i}``), BatchNorm (``bn{i}``; eps 1e-5,
    flax momentum 0.9) and ReLU for each width of ``channels``, over the
    last axis of any (..., C) rows; in train mode each BN takes its
    statistics over every row, padded ones included, as flax's
    ``nn.BatchNorm`` (JAX's ``point_rcnn._FCStack``, ``pvrcnn._GroupMLP``
    and the RCNN heads' FC layers)."""

    def __init__(self, in_channels: int, channels: Sequence[int], dtype=None):
        super().__init__()
        self.dtype, self.depth = dtype, len(channels)
        for i, c in enumerate(channels):
            setattr(self, f"fc{i}", nn.Linear(in_channels, c, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm1d(c, eps=1e-5, momentum=0.1))
            in_channels = c

    def forward(self, h):
        dt = compute_dtype(self.dtype)
        for i in range(self.depth):
            h = torch.relu(batch_norm(linear(h, getattr(self, f"fc{i}"), dt),
                                      getattr(self, f"bn{i}"), dt))
        return h


class GroupMLP(FCStack):
    """The shared per-point MLP of a set abstraction (an ``FCStack``) over
    (B, K, S, C) grouped rows, the empty groups' rows zeroed after it, then
    the max over each group's S."""

    def forward(self, grouped, group_valid):
        h = super().forward(grouped)
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


class RCNNHead(FCStack):
    """Shared FCs (256, 256; an ``FCStack``) over each RoI's flattened grid
    features -> (cls (B, R), reg (B, R, 7)), f32."""

    def __init__(self, in_channels: int, dtype=None):
        super().__init__(in_channels, (256, 256), dtype)
        self.cls = nn.Linear(256, 1)
        self.reg = nn.Linear(256, 7)

    def forward(self, pooled):
        dt = compute_dtype(self.dtype)
        h = super().forward(pooled.flatten(2))
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


# -- PV-RCNN and PV-RCNN++ ------------------------------------------------------

def interpolate_bev(bev, xy, pc_range, voxel_size, stride: int):
    """Bilinear BEV features (B, H, W, C) at metric (x, y) (B, K, 2) ->
    (B, K, C): the coordinate (x - range min) / (voxel x stride) with no
    half-texel shift, its four taps clamped to the map's border (a point at
    a cell's metric centre blends that cell and the next 50/50). Not
    ``roi_heads.bilinear_sample_pixel``, which zeroes taps outside the map."""
    b, h, w, c = bev.shape
    fx = div_exact(xy[..., 0] - pc_range[0], voxel_size[0] * stride)
    fy = div_exact(xy[..., 1] - pc_range[1], voxel_size[1] * stride)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[..., None], (fy - y0)[..., None]
    flat_map = bev.reshape(b, h * w, c)

    def tap(xi, yi):
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        return torch.take_along_dim(flat_map, (yc * w + xc)[..., None], dim=1)

    return (tap(x0, y0) * (1 - tx) * (1 - ty) + tap(x0 + 1, y0) * tx * (1 - ty)
            + tap(x0, y0 + 1) * (1 - tx) * ty + tap(x0 + 1, y0 + 1) * tx * ty)


def gather_points(xyz, idx):
    """(B, N, 3) points at (B, K) indices -> (B, K, 3)."""
    return torch.take_along_dim(xyz, idx[..., None], dim=1)


def sample_keypoints_proposal_centric(xyz, valid, rois, roi_valid, num_keypoints: int,
                                      radius_extra: float = 1.6):
    """PV-RCNN++'s keypoints (B, K, 3): the valid points within half a
    proposal's diagonal + ``radius_extra`` of a valid proposal's centre (all
    valid points of a frame where none is), one masked farthest-point
    sampling of them."""
    dims = rois[..., 3:6]
    half_diag = torch.sqrt((dims[..., 0] * dims[..., 0] + dims[..., 1] * dims[..., 1])
                           + dims[..., 2] * dims[..., 2]) / 2.0
    d = xyz[:, :, None, :] - rois[:, None, :, :3]
    dist = torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])
    near = ((dist < (half_diag + radius_extra)[:, None, :]) & roi_valid[:, None, :]).any(-1)
    near = near & valid
    sel = torch.where(near.any(-1, keepdim=True), near, valid)
    return gather_points(xyz, farthest_point_sample(xyz, sel, num_keypoints))


class VectorPoolLocal(nn.Module):
    """VectorPool aggregation: each centre's ball (``nsample`` slots of the
    ball query) split into a ``grid_n``^3 grid of sub-voxels over [-r, r]^3;
    each sub-voxel the average of its slots' (relative xyz / r, features),
    zeros where none falls, an empty ball all zeros; the flattened
    (grid_n^3 (3 + C)) vector through ``fc`` (no bias), ``bn``, ReLU: a
    weight slice for each sub-voxel position."""

    def __init__(self, in_channels: int, radius: float, out_channels: int, nsample: int = 32,
                 grid_n: int = 3, dtype=None):
        super().__init__()
        self.radius, self.nsample, self.grid_n, self.dtype = radius, nsample, grid_n, dtype
        self.fc = nn.Linear(grid_n ** 3 * (3 + in_channels), out_channels, bias=False)
        self.bn = nn.BatchNorm1d(out_channels, eps=1e-5, momentum=0.1)

    def pool(self, new_xyz, xyz, features, valid, grid=None):
        """One frame: (M, 3) centres over (N, 3) points (a grid's cell
        centres with ``grid``) -> (M, grid_n^3 (3 + C)) cell averages."""
        if grid is None:
            idx, any_nb = ball_query(new_xyz, xyz, valid, self.radius, self.nsample)
        else:
            idx, any_nb = ball_query_grid(new_xyz, *grid, valid, self.radius, self.nsample)
        n = self.grid_n
        rel = div_exact(xyz[idx] - new_xyz[:, None, :], self.radius)  # (M, S, 3) in [-1, 1]
        feats = torch.cat([rel, features[idx].to(rel.dtype)], dim=-1)
        cell = torch.clamp(torch.floor((rel + 1.0) / 2.0 * n), 0, n - 1).long()
        flat = (cell[..., 0] * n + cell[..., 1]) * n + cell[..., 2]
        onehot = (flat[..., None] == torch.arange(n ** 3, device=flat.device)).to(rel.dtype)
        sums = torch.bmm(onehot.transpose(1, 2), feats)  # (M, n^3, 3 + C)
        cells = sums / torch.clamp(onehot.sum(1), min=1.0)[..., None]
        return cells.flatten(1) * any_nb[:, None].to(cells.dtype)

    def forward(self, new_xyz, xyz, features, valid, grid=None):
        """new_xyz (B, M, 3), xyz (B, N, 3) (or (N, 3) for every frame),
        features (B, N, C), valid (B, N) -> (B, M, out_channels)."""
        pooled = torch.stack([self.pool(new_xyz[f], xyz if xyz.dim() == 2 else xyz[f],
                                        features[f], valid[f], grid)
                              for f in range(new_xyz.shape[0])])
        dt = compute_dtype(self.dtype)
        return torch.relu(batch_norm(linear(pooled, self.fc, dt), self.bn, dt))


class VoxelSetAbstraction(nn.Module):
    """The keypoints and their features (``pfe``): ``num_keypoints`` a frame
    by FPS over the valid points (PV-RCNN) or proposal-centric
    (``sample_keypoints_proposal_centric``, PV-RCNN++); at each keypoint
    the stride-``bev_stride`` BEV map (``interpolate_bev``), the raw points'
    features (``sa_raw``: radii 0.4 / 0.8) and x_conv3's and x_conv4's
    (``sa_x_conv3`` 1.2 / 2.4, ``sa_x_conv4`` 2.4 / 4.8), 16 samples each;
    with ``aggregation`` "vectorpool" ``vp_raw`` (0.8, 32 wide),
    ``vp_x_conv3`` (2.4, 64) and ``vp_x_conv4`` (4.8, 64) instead; the
    concatenation through ``fusion_fc``, ``fusion_bn``, ReLU to
    ``out_channels``, f32."""

    STAGES = (("x_conv3", (1.2, 2.4)), ("x_conv4", (2.4, 4.8)))

    def __init__(self, point_channels: int, bev_channels: int, stage_channels: Dict[str, int],
                 num_keypoints: int, pc_range, voxel_size, bev_stride: int = 8,
                 out_channels: int = 128, aggregation: str = "sa", dtype=None):
        super().__init__()
        if aggregation not in ("sa", "vectorpool"):
            raise ValueError(f"VSA aggregation {aggregation!r}: 'sa' or 'vectorpool'")
        self.num_keypoints, self.bev_stride = num_keypoints, bev_stride
        self.pc_range, self.voxel_size = tuple(pc_range), tuple(voxel_size)
        self.aggregation, self.dtype = aggregation, dtype
        if aggregation == "vectorpool":
            self.vp_raw = VectorPoolLocal(point_channels, 0.8, 32, dtype=dtype)
            width = bev_channels + 32
            for name, radii in self.STAGES:
                setattr(self, f"vp_{name}", VectorPoolLocal(stage_channels[name], radii[-1], 64,
                                                            dtype=dtype))
                width += 64
        else:
            self.sa_raw = SALayer(point_channels, (0.4, 0.8), (16, 16), ((16, 16), (16, 16)),
                                  dtype=dtype)
            width = bev_channels + 32
            for name, radii in self.STAGES:
                setattr(self, f"sa_{name}", SALayer(stage_channels[name], radii, (16, 16),
                                                    ((32, 32), (32, 32)), dtype=dtype))
                width += 64
        self.fusion_fc = nn.Linear(width, out_channels, bias=False)
        self.fusion_bn = nn.BatchNorm1d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, points, points_valid, bev, stages, rois=None, roi_valid=None):
        """points (B, N, 3 + C), points_valid (B, N), bev (B, H, W, C'),
        stages (``VoxelBackBone8x``'s), and for the proposal-centric
        keypoints the proposals (B, R, 7) and their valid mask ->
        (keypoints (B, K, 3), features (B, K, out_channels) f32)."""
        xyz = points[..., :3].float()
        if rois is not None:
            keypoints = sample_keypoints_proposal_centric(xyz, points_valid, rois, roi_valid,
                                                          self.num_keypoints)
        else:
            keypoints = gather_points(xyz, farthest_point_sample(xyz, points_valid,
                                                                 self.num_keypoints))
        feats = [interpolate_bev(bev, keypoints[..., :2], self.pc_range, self.voxel_size,
                                 self.bev_stride)]
        prefix = "vp" if self.aggregation == "vectorpool" else "sa"
        feats.append(getattr(self, f"{prefix}_raw")(keypoints, xyz, points[..., 3:],
                                                    points_valid))
        for name, _ in self.STAGES:
            centers, sf, sv, geometry = stage_point_set(stages[name], self.pc_range,
                                                        self.voxel_size)
            feats.append(getattr(self, f"{prefix}_{name}")(keypoints, centers, sf, sv,
                                                           grid=geometry))
        dt = compute_dtype(self.dtype)
        fused = torch.cat([f.to(dt) for f in feats], dim=-1)
        fused = batch_norm(linear(fused, self.fusion_fc, dt), self.fusion_bn, dt)
        return keypoints, torch.relu(fused).float()


class KeypointWeighting(FCStack):
    """The predicted keypoint weighting (``point_head``): an ``FCStack``
    (256, 256), then the foreground logit ``cls``; returns (features x
    sigmoid(logit), logit (B, K, 1) f32)."""

    def __init__(self, in_channels: int, dtype=None):
        super().__init__(in_channels, (256, 256), dtype)
        self.cls = nn.Linear(256, 1)

    def forward(self, feats):
        dt = compute_dtype(self.dtype)
        logit = linear(super().forward(feats), self.cls, dt).float()
        return feats * torch.sigmoid(logit), logit


class RoIGridPool(nn.Module):
    """The keypoints' features at each RoI's ``grid_size``^3 grid points
    (``roi_grid_points``): ``pool``, an SALayer (radii 0.8 / 1.6, 16
    samples, MLPs (64, 64) twice) over the dense ball query of the
    keypoints, or with ``aggregation`` "vectorpool" ``pool_vp``
    (VectorPoolLocal at 1.6, 128 wide) -> (B, R, grid^3, 128)."""

    def __init__(self, in_channels: int, grid_size: int = 6, aggregation: str = "sa",
                 dtype=None):
        super().__init__()
        if aggregation not in ("sa", "vectorpool"):
            raise ValueError(f"RoI grid pool aggregation {aggregation!r}: 'sa' or 'vectorpool'")
        self.grid_size = grid_size
        if aggregation == "vectorpool":
            self.pool_vp = VectorPoolLocal(in_channels, 1.6, 128, dtype=dtype)
        else:
            self.pool = SALayer(in_channels, (0.8, 1.6), (16, 16), ((64, 64), (64, 64)),
                                dtype=dtype)

    def forward(self, rois, keypoints, kp_feats):
        b, r = rois.shape[:2]
        grid = roi_grid_points(rois, self.grid_size).reshape(b, r * self.grid_size ** 3, 3)
        kv = torch.ones(keypoints.shape[:2], dtype=torch.bool, device=keypoints.device)
        pool = self.pool_vp if hasattr(self, "pool_vp") else self.pool
        return pool(grid, keypoints, kp_feats, kv).reshape(b, r, self.grid_size ** 3, -1)


def point_fg_loss(point_logits, keypoints, gt_boxes, extra_width=(0.2, 0.2, 0.2)):
    """The keypoints' foreground loss: sigmoid focal loss of (B, K, 1)
    logits against "inside a real gt box", keypoints in a box's shell
    enlarged by ``extra_width`` (and in no box) ignored, summed and divided
    by the positives (at least 1)."""
    fgs, ignores = [], []
    widths = device_constant(tuple(extra_width), gt_boxes.dtype, gt_boxes.device)
    for f in range(keypoints.shape[0]):
        gt = gt_boxes[f]
        real = (gt[:, -1] > 0)[:, None]
        inb = points_in_boxes(keypoints[f], gt[:, :7]) & real
        big = torch.cat([gt[:, :3], gt[:, 3:6] + widths, gt[:, 6:7]], dim=-1)
        in_big = points_in_boxes(keypoints[f], big) & real
        fg = inb.any(0)
        fgs.append(fg)
        ignores.append(in_big.any(0) & ~fg)
    fg = torch.stack(fgs).to(torch.float32)
    weights = 1.0 - torch.stack(ignores).to(torch.float32)
    pos_norm = torch.clamp(fg.sum(), min=1.0)
    return sigmoid_focal_loss(point_logits[..., :1], fg[..., None], weights / pos_norm).sum()
