"""DDN depth-distribution loss with foreground/background balancing.

Counterpart of ``hgsfusion_tpu/models/ddn_loss.py`` (the reference's
ddn_loss.py + balancer.py: kornia's focal loss over binned depth targets,
fg/bg weights from the 2-D gt boxes, the sum normalized by the pixel count;
loss_utils.compute_fg_mask). Training adds it when the model runs with
USE_DEPTH and the batch carries depth maps (``train/trainer.py``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .frustum import bin_depths


def bin_depth_target(depth_map, mode: str, depth_min: float, depth_max: float,
                     num_bins: int):
    """Integer depth-bin targets (transform_utils.bin_depths, target=True):
    out-of-range and non-finite depths map to the overflow bin ``num_bins``."""
    idx = bin_depths(depth_map, mode, depth_min, depth_max, num_bins)
    bad = (idx < 0) | (idx > num_bins) | ~torch.isfinite(idx)
    return torch.where(bad, torch.full_like(idx, num_bins), idx).to(torch.int32)


def compute_fg_mask(gt_boxes2d, shape, downsample_factor: int = 1):
    """(B, N, 4) 2-D boxes (u1, v1, u2, v2) -> (B, H, W) bool foreground mask:
    floor of the minima, ceil of the maxima, the half-open [v1, v2) x
    [u1, u2) filled. Zero-area (padded) boxes add nothing."""
    _, h, w = shape
    boxes = gt_boxes2d / downsample_factor
    u1, v1 = torch.floor(boxes[..., 0]), torch.floor(boxes[..., 1])
    u2, v2 = torch.ceil(boxes[..., 2]), torch.ceil(boxes[..., 3])
    us = torch.arange(w, dtype=boxes.dtype, device=boxes.device)
    vs = torch.arange(h, dtype=boxes.dtype, device=boxes.device)
    in_u = (us >= u1[..., None]) & (us < u2[..., None])  # (B, N, W)
    in_v = (vs >= v1[..., None]) & (vs < v2[..., None])  # (B, N, H)
    return (in_v[:, :, :, None] & in_u[:, :, None, :]).any(dim=1)


def focal_ce(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """kornia-style multi-class focal loss per pixel (no reduction):
    -alpha (1 - p_t)^gamma log p_t, p_t the softmax probability of the
    target class."""
    logp = torch.log_softmax(logits, dim=-1)
    logpt = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    pt = torch.exp(logpt)
    return -alpha * torch.pow(1.0 - pt, gamma) * logpt


def ddn_loss(depth_logits, depth_maps, gt_boxes2d, disc_cfg: Dict,
             weight: float = 3.0, alpha: float = 0.25, gamma: float = 2.0,
             fg_weight: float = 13.0, bg_weight: float = 1.0,
             downsample_factor: int = 1) -> Tuple[torch.Tensor, Dict]:
    """depth_logits (B, H, W, D+1), depth_maps (B, H, W), gt_boxes2d
    (B, N, 4) -> (loss, {"ddn_loss", "fg_loss", "bg_loss"})."""
    target = bin_depth_target(depth_maps, **disc_cfg)
    pixel_loss = focal_ce(depth_logits, target, alpha=alpha, gamma=gamma)
    fg = compute_fg_mask(gt_boxes2d, pixel_loss.shape, downsample_factor).to(pixel_loss.dtype)
    weights = fg_weight * fg + bg_weight * (1.0 - fg)
    num_pixels = pixel_loss.numel()
    weighted = pixel_loss * weights
    fg_loss = torch.sum(weighted * fg) / num_pixels
    bg_loss = torch.sum(weighted * (1.0 - fg)) / num_pixels
    total = (fg_loss + bg_loss) * weight
    return total, {"ddn_loss": total, "fg_loss": fg_loss, "bg_loss": bg_loss}
