"""The CenterPoint head: a shared 3x3 conv and separate branches over NHWC
BEV features, its heatmap targets, its losses and its fixed-shape decode.

Counterpart of ``hgsfusion_tpu/models/center_head.py`` (``gaussian_radius``,
``center_targets``, ``centernet_focal_loss``, ``center_reg_loss``,
``center_head_loss``, ``SeparateHead``, ``CenterHead``,
``decode_center_boxes``); the TransFusion loss draws its dense heatmap from
the same targets. The targets are vectorized over the padded (B, M, >= 8)
gt tensor: one gaussian per object on an (M, H, W) batch, max-combined per
class; no host loop and no host read. Parameter names are the JAX
package's (its converter maps none of the reference's): ``shared_conv``,
``shared_bn``, ``head.{name}_conv{i}`` / ``_bn{i}`` / ``_out``. The
BatchNorms follow flax (eps 1e-5, flax momentum 0.9, torch 0.1); the
outputs are f32.

The decode takes the top min(K, C H W) of the sigmoid heatmap flattened as
c H W + pos by a stable descending sort (``ops.nms.top_scores``), so equal
scores rank by index as JAX's ``exact_top_k`` ranks them, and pads back to K with
invalid slots.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.nms import top_scores
from ..utils.common import device_constant
from .layers import batch_norm, compute_dtype, conv_nhwc

# the heatmap branch's last bias (the focal prior, SeparateHead's init_bias)
HM_INIT_BIAS = -2.19


def gaussian_radius(height, width, min_overlap: float = 0.5):
    """CornerNet's gaussian radius, the least root of its three IoU
    quadratics, each root halved instead of divided by 2a (the inherited
    CornerNet quirk, kept for parity). Called with (dx, dy), as the
    reference does."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def center_targets(gt_boxes, num_class: int, feature_map_hw: Tuple[int, int],
                   feature_map_stride: int, pc_range: Sequence[float],
                   voxel_size: Sequence[float], gaussian_overlap: float = 0.1,
                   min_radius: int = 2, code_size: int = 8) -> Dict[str, torch.Tensor]:
    """CenterNet targets of padded (B, M, >= 8) gt boxes (class 0 and zero
    dims on a padding row, which is masked out). Returns heatmap (B, H, W,
    C), the max of the int-centered gaussians of each class; boxes (B, M,
    code_size) [frac dx, frac dy, z, log dims, cos, sin, extras]; inds (B, M)
    the flat H W index of the int center; mask (B, M) bool."""
    h, w = feature_map_hw
    dt = gt_boxes.dtype
    cls = gt_boxes[..., -1].to(torch.int32)  # 1-based, 0 = padding
    x, y, z = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
    dx = gt_boxes[..., 3] / (voxel_size[0] * feature_map_stride)
    dy = gt_boxes[..., 4] / (voxel_size[1] * feature_map_stride)
    coord_x = torch.clamp((x - pc_range[0]) / (voxel_size[0] * feature_map_stride), 0, w - 0.5)
    coord_y = torch.clamp((y - pc_range[1]) / (voxel_size[1] * feature_map_stride), 0, h - 0.5)
    cx_int = coord_x.to(torch.int32)
    cy_int = coord_y.to(torch.int32)
    radius = torch.clamp(gaussian_radius(dx, dy, gaussian_overlap).to(torch.int32),
                         min=min_radius)
    valid = (dx > 0) & (dy > 0) & (cls > 0)

    # the int-centered gaussian inside |u - cx| <= r, |v - cy| <= r
    sigma = (2 * radius.to(dt) + 1) / 6.0
    du = torch.arange(w, dtype=dt, device=gt_boxes.device)[None, None] - cx_int[..., None].to(dt)
    dv = torch.arange(h, dtype=dt, device=gt_boxes.device)[None, None] - cy_int[..., None].to(dt)
    r_f = radius[..., None].to(dt)
    in_u = (du.abs() <= r_f) & valid[..., None]
    in_v = dv.abs() <= r_f
    g = torch.exp(-(du[:, :, None, :] ** 2 + dv[:, :, :, None] ** 2)
                  / (2.0 * sigma[..., None, None] ** 2))
    g = g * (in_v[:, :, :, None] & in_u[:, :, None, :]).to(dt)  # (B, M, H, W)
    heatmap = torch.stack(
        [torch.where((cls == c + 1)[..., None, None], g, torch.zeros((), dtype=dt,
                                                                     device=g.device)).amax(1)
         for c in range(num_class)], dim=-1)

    safe_dims = torch.clamp(gt_boxes[..., 3:6], min=1e-6)
    cols = [(coord_x - cx_int)[..., None], (coord_y - cy_int)[..., None], z[..., None],
            torch.log(safe_dims), torch.cos(gt_boxes[..., 6:7]), torch.sin(gt_boxes[..., 6:7])]
    if code_size > 8:  # extras (e.g. velocity), gt columns 7:-1
        n_extra = code_size - 8
        if gt_boxes.shape[-1] < 8 + n_extra:
            raise ValueError(f"code_size {code_size} needs gt boxes with {7 + n_extra} feature "
                             f"columns (+class), got width {gt_boxes.shape[-1]}")
        cols.append(gt_boxes[..., 7:7 + n_extra])
    boxes = torch.cat(cols, dim=-1) * valid[..., None].to(dt)
    inds = torch.where(valid, cy_int * w + cx_int, torch.zeros_like(cx_int)).to(torch.int32)
    return {"heatmap": heatmap, "boxes": boxes, "inds": inds, "mask": valid}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def centernet_focal_loss(pred_logits, gt_heatmap):
    """CornerNet focal loss on the sigmoid clamped to [1e-4, 1 - 1e-4],
    NHWC; the sum over the negatives alone where no cell is a peak."""
    p = torch.clamp(torch.sigmoid(pred_logits), 1e-4, 1 - 1e-4)
    pos = (gt_heatmap == 1.0).to(p.dtype)
    neg = (gt_heatmap < 1.0).to(p.dtype)
    neg_w = torch.pow(1.0 - gt_heatmap, 4)
    pos_loss = torch.sum(torch.log(p) * torch.pow(1 - p, 2) * pos)
    neg_loss = torch.sum(torch.log(1 - p) * torch.pow(p, 2) * neg_w * neg)
    num_pos = torch.sum(pos)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def center_reg_loss(pred_maps, inds, mask, target_boxes):
    """Masked L1 at the gt center cells, summed per channel over the
    objects and divided by their count (at least 1); a target that is not
    finite counts as masked. pred_maps (B, H, W, D), inds (B, M), mask (B,
    M), target_boxes (B, M, D) -> (D,)."""
    b, h, w, d = pred_maps.shape
    pred = torch.take_along_dim(pred_maps.reshape(b, h * w, d), inds.long()[..., None], dim=1)
    finite = torch.isfinite(target_boxes)
    m = mask.to(pred.dtype)[..., None] * finite.to(pred.dtype)
    num = torch.clamp(torch.sum(mask.to(pred.dtype)), min=1.0)
    tgt = torch.where(finite, target_boxes, torch.zeros_like(target_boxes))
    return torch.sum(torch.abs(pred * m - tgt * m), dim=(0, 1)) / num


def center_head_loss(preds: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                     head_order: Sequence[str], code_weights: Sequence[float],
                     cls_weight: float = 1.0, loc_weight: float = 2.0):
    """The CenterHead loss of one head group: the heatmap's focal loss times
    ``cls_weight`` plus the per-channel L1 of the regression branches (in
    ``head_order``) weighted by ``code_weights``, times ``loc_weight``.
    Returns (total, {"hm_loss", "loc_loss_center"})."""
    hm_loss = centernet_focal_loss(preds["hm"], targets["heatmap"]) * cls_weight
    reg_maps = torch.cat([preds[k] for k in head_order], dim=-1)
    per_channel = center_reg_loss(reg_maps, targets["inds"], targets["mask"], targets["boxes"])
    weights = device_constant(tuple(float(w) for w in code_weights), per_channel.dtype,
                              per_channel.device)
    loc_loss = torch.sum(per_channel * weights) * loc_weight
    total = hm_loss + loc_loss
    return total, {"hm_loss": hm_loss, "loc_loss_center": loc_loss}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class SeparateHead(nn.Module):
    """Per branch (``head_dict``: (name, out_channels, num_conv), ...) a
    stack of ``num_conv - 1`` 3x3 conv (no bias) / BN / ReLU layers and a
    3x3 output conv with a bias; the outputs f32."""

    def __init__(self, in_channels: int, head_dict, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.branches = tuple((name, num_conv) for name, _, num_conv in head_dict)
        for name, out_ch, num_conv in head_dict:
            for i in range(num_conv - 1):
                setattr(self, f"{name}_conv{i}", nn.Conv2d(in_channels, in_channels, 3,
                                                           padding=1, bias=False))
                setattr(self, f"{name}_bn{i}", nn.BatchNorm2d(in_channels, eps=1e-5,
                                                              momentum=0.1))
            setattr(self, f"{name}_out", nn.Conv2d(in_channels, out_ch, 3, padding=1))

    def forward(self, x):
        dt = compute_dtype(self.dtype)
        out = {}
        for name, num_conv in self.branches:
            h = x
            for i in range(num_conv - 1):
                h = conv_nhwc(h, getattr(self, f"{name}_conv{i}"), dt)
                h = torch.relu(batch_norm(h, getattr(self, f"{name}_bn{i}"), dt))
            out[name] = conv_nhwc(h, getattr(self, f"{name}_out"), dt).float()
        return out


class CenterHead(nn.Module):
    """A shared 3x3 conv (no bias) / BN / ReLU and the separate branches of
    one head group covering every class: the regression branches in
    ``head_order`` (``head_channels`` wide) and ``hm`` (``num_class``
    wide). (B, H, W, C) -> {name: (B, H, W, width) f32}."""

    def __init__(self, in_channels: int, num_class: int, shared_channels: int = 64,
                 head_order=("center", "center_z", "dim", "rot"), head_channels=(2, 1, 3, 2),
                 num_conv: int = 2, num_hm_conv: int = 2, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.shared_conv = nn.Conv2d(in_channels, shared_channels, 3, padding=1, bias=False)
        self.shared_bn = nn.BatchNorm2d(shared_channels, eps=1e-5, momentum=0.1)
        head_dict = tuple((n, c, num_conv) for n, c in zip(head_order, head_channels)) \
            + (("hm", num_class, num_hm_conv),)
        self.head = SeparateHead(shared_channels, head_dict, dtype)

    def init_biases(self):
        """The heatmap branch's focal prior (every other output bias stays 0)."""
        with torch.no_grad():
            self.head.hm_out.bias.fill_(HM_INIT_BIAS)

    def forward(self, feats):
        dt = compute_dtype(self.dtype)
        h = torch.relu(batch_norm(conv_nhwc(feats, self.shared_conv, dt), self.shared_bn, dt))
        return self.head(h)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_center_boxes(preds: Dict[str, torch.Tensor], k: int, feature_map_stride: int,
                        pc_range: Sequence[float], voxel_size: Sequence[float],
                        post_center_limit_range: Sequence[float],
                        score_thresh: float = 0.1) -> Dict[str, torch.Tensor]:
    """Fixed-shape decode: the global top K of the (C H W) sigmoid heatmap,
    the regression maps gathered at those cells, the centers mapped to
    metres, dims ``exp`` of the prediction clamped to +-10, the heading
    ``atan2(sin, cos)``; a candidate is valid inside the post-center range
    and above ``score_thresh``. Returns boxes (B, K, 7), scores (B, K),
    1-based labels (B, K) int64, valid (B, K), and vels (B, K, 2) where the
    head has ``vel``; slots past C H W are invalid zeros."""
    hm = torch.sigmoid(preds["hm"].float())
    b, h, w, c = hm.shape
    k_eff = min(k, c * h * w)
    scores, flat_idx = top_scores(hm.permute(0, 3, 1, 2).reshape(b, -1), k_eff)
    cls_id = flat_idx // (h * w)
    spatial = flat_idx % (h * w)
    ys = (spatial // w).float()
    xs = (spatial % w).float()

    def gather(name):
        m = preds[name]
        return torch.take_along_dim(m.reshape(b, h * w, m.shape[-1]), spatial[..., None], dim=1)

    off = gather("center")
    zc = gather("center_z")[..., 0]
    dims = torch.exp(torch.clamp(gather("dim"), -10.0, 10.0))
    rot = gather("rot")
    angle = torch.atan2(rot[..., 1], rot[..., 0])
    xs = (xs + off[..., 0]) * feature_map_stride * voxel_size[0] + pc_range[0]
    ys = (ys + off[..., 1]) * feature_map_stride * voxel_size[1] + pc_range[1]
    boxes = torch.stack([xs, ys, zc, dims[..., 0], dims[..., 1], dims[..., 2], angle], dim=-1)
    lim = device_constant(tuple(float(v) for v in post_center_limit_range), torch.float32,
                          boxes.device)
    ok = (boxes[..., :3] >= lim[:3]).all(-1) & (boxes[..., :3] <= lim[3:]).all(-1)
    ok = ok & (scores > score_thresh)
    out = {"boxes": boxes, "scores": scores, "labels": cls_id + 1, "valid": ok}
    if "vel" in preds:
        out["vels"] = gather("vel")
    if k_eff < k:  # pad back to the caller's K with invalid slots
        out = {key: torch.cat([v, v.new_zeros((b, k - k_eff) + v.shape[2:])], dim=1)
               for key, v in out.items()}
    return out
