"""CenterNet heatmap targets (counterpart of the JAX package's
``models/center_head.py``: ``gaussian_radius`` and ``center_targets``),
which the TransFusion loss draws its dense heatmap from. Vectorized over the
padded (B, M, >= 8) gt tensor: one gaussian per object on an (M, H, W)
batch, max-combined per class; no host loop and no host read."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


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
