"""Rotated BEV overlap / IoU by the sort-free boundary integral, and the
rotated 3D IoU on top of it.

Counterpart of ``hgsfusion_tpu/ops/rotated_iou.py``: the intersection of two
convex quads is the sum over each quad's edges, clipped to the other quad's
half-planes as a 1-D interval, of the shoelace term 0.5 * cross(p, q). No
sort, no gather, no data-dependent control flow.
"""
from __future__ import annotations

import torch

from ..utils.box_utils import boxes_to_corners_bev

_EPS = 1e-8
# collinearity tolerances: only true degeneracies (duplicated boxes) hit them
_EPS_PAR = 1e-6
_EPS_COLL = 1e-5


def _half_boundary(cp, cq, first_pass: bool):
    """Shoelace contribution of polygon P's edges clipped to inside Q.

    cp, cq (..., 4, 2) CCW corners. A P-edge lying on a Q-edge line counts
    only in the first pass and only if the edges point the same way.
    """
    d = torch.roll(cp, -1, dims=-2) - cp
    e = torch.roll(cq, -1, dims=-2) - cq
    rel = cp[..., :, None, :] - cq[..., None, :, :]  # (..., 4P, 4Q, 2)
    a = e[..., None, :, 0] * rel[..., 1] - e[..., None, :, 1] * rel[..., 0]
    b = e[..., None, :, 0] * d[..., :, None, 1] - e[..., None, :, 1] * d[..., :, None, 0]
    parallel = torch.abs(b) <= _EPS_PAR
    tc = -a / torch.where(parallel, torch.ones_like(b), b)
    zero, one = torch.zeros_like(tc), torch.ones_like(tc)
    lo = torch.where(~parallel & (b > 0), tc, zero)
    hi = torch.where(~parallel & (b < 0), tc, one)
    collinear = parallel & (torch.abs(a) <= _EPS_COLL)
    if first_pass:
        same_dir = (d[..., :, None, 0] * e[..., None, :, 0]
                    + d[..., :, None, 1] * e[..., None, :, 1]) > 0
        parallel_ok = torch.where(collinear, same_dir, a > 0)
    else:
        parallel_ok = ~collinear & (a > 0)
    hi = torch.where(parallel & ~parallel_ok, -one, hi)
    t_lo = torch.clamp(lo.amax(dim=-1), min=0.0)
    t_hi = torch.clamp(hi.amin(dim=-1), max=1.0)
    valid = t_hi > t_lo
    pa = cp + t_lo[..., None] * d
    pb = cp + t_hi[..., None] * d
    contrib = pa[..., 0] * pb[..., 1] - pa[..., 1] * pb[..., 0]
    return 0.5 * torch.where(valid, contrib, torch.zeros_like(contrib)).sum(dim=-1)


def _pairwise_intersection_from_corners(ca, cb):
    """Intersection area of corner sets ca, cb (..., 4, 2), computed about
    the pair's joint centroid to keep f32 cross terms small."""
    center = 0.5 * (ca.mean(dim=-2, keepdim=True) + cb.mean(dim=-2, keepdim=True))
    ca = ca - center
    cb = cb - center
    area = _half_boundary(ca, cb, True) + _half_boundary(cb, ca, False)
    return torch.clamp(area, min=0.0)


def boxes_overlap_bev(boxes_a, boxes_b):
    """Rotated BEV intersection areas, (N, 7) x (M, 7) -> (N, M)."""
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    return _pairwise_intersection_from_corners(
        ca[:, None].expand(n, m, 4, 2), cb[None, :].expand(n, m, 4, 2))


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU (N, M)."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)


def boxes_iou3d(boxes_a, boxes_b):
    """Rotated 3D IoU (N, M): the BEV overlap times the height overlap over
    the union of the volumes (the JAX package's ``boxes_iou3d``)."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_max = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    a_min = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    b_max = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    b_min = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    overlap_h = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0.0)
    inter3d = inter_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter3d / torch.clamp(vol_a + vol_b - inter3d, min=1e-6)
