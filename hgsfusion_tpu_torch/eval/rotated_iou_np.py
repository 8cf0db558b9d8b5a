"""Rotated rectangle overlap (offline eval path): a copy of
``hgsfusion_tpu/eval/rotated_iou_np.py`` whose ``rotate_iou_eval`` always
runs the C++ version.

Replaces the reference's numba.cuda rotate_iou_gpu_eval
(pcdet/datasets/kitti/kitti_object_eval_python/rotate_iou.py:73-330 and the
njit copy utils/rotate_iou_cpu.py) with the same candidate-points +
convex-hull method used by the on-device jnp kernel (ops/rotated_iou.py),
vectorized over all box pairs.

Box format: (cx, cy, w, h, angle) — the KITTI eval convention where camera
BEV boxes are location[:, [0, 2]], dims[:, [0, 2]], rotation_y.
criterion: -1 IoU (union), 0 overlap/area_a, 1 overlap/area_b,
2 raw intersection area (used by the 3D metric before height fusion).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from .. import native


def _corners(boxes5):
    """(N, 5) -> (N, 4, 2) corners, rotated CLOCKWISE for positive angle
    (rotation [[c, s], [-s, c]]) — the KITTI/second.pytorch eval
    convention (reference rotate_iou_cpu.rbbox_to_corners:206-229). The
    sign matters: the relative geometry of two boxes with DIFFERENT
    headings mirrors under the opposite convention, changing IoUs."""
    cx, cy, w, h, ang = [boxes5[:, i] for i in range(5)]
    template = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float64) / 2
    dxy = np.stack([w, h], axis=1)[:, None, :] * template[None]
    c, s = np.cos(ang), np.sin(ang)
    x = dxy[..., 0] * c[:, None] + dxy[..., 1] * s[:, None]
    y = -dxy[..., 0] * s[:, None] + dxy[..., 1] * c[:, None]
    return np.stack([x + cx[:, None], y + cy[:, None]], axis=-1)


_EPS = 1e-8
_EPS_INSIDE = 1e-6


def _pairwise_intersection(ca, cb):
    """ca (N, 4, 2), cb (M, 4, 2) -> (N, M) intersection areas."""
    n, m = ca.shape[0], cb.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float64)
    A = np.broadcast_to(ca[:, None], (n, m, 4, 2))
    B = np.broadcast_to(cb[None, :], (n, m, 4, 2))

    def edges(c):
        return c, np.roll(c, -1, axis=-2)

    # 16 edge-pair intersections
    pa, pb = edges(A)
    qa, qb = edges(B)
    p1 = pa[..., :, None, :]
    p2 = pb[..., :, None, :]
    q1 = qa[..., None, :, :]
    q2 = qb[..., None, :, :]
    r = p2 - p1
    s = q2 - q1
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q1 - p1
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    safe = np.where(np.abs(denom) > _EPS, denom, 1.0)
    t = t_num / safe
    u = u_num / safe
    inter_valid = (
        (np.abs(denom) > _EPS) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    ).reshape(n, m, 16)
    inter_pts = (p1 + t[..., None] * r).reshape(n, m, 16, 2)

    def inside(points, quad):
        s0, e0 = edges(quad)
        d = e0 - s0
        rel = points[..., :, None, :] - s0[..., None, :, :]
        cross = d[..., None, :, 0] * rel[..., 1] - d[..., None, :, 1] * rel[..., 0]
        return np.all(cross >= -_EPS_INSIDE, axis=-1)

    a_in_b = inside(A, B)
    b_in_a = inside(B, A)
    pts = np.concatenate([inter_pts, A, B], axis=2)  # (n, m, 24, 2)
    valid = np.concatenate([inter_valid, a_in_b, b_in_a], axis=2)

    validf = valid.astype(np.float64)
    count = validf.sum(-1)
    center = (pts * validf[..., None]).sum(-2) / np.maximum(count, 1)[..., None]
    rel = pts - center[..., None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    key = np.where(valid, ang, np.inf)
    order = np.argsort(key, axis=-1)
    srel = np.take_along_axis(rel, order[..., None], axis=-2)
    idx = np.broadcast_to(np.arange(24), valid.shape)
    nxt = np.where(idx + 1 >= count[..., None], 0, idx + 1)
    nrel = np.take_along_axis(srel, nxt[..., None], axis=-2)
    cross = srel[..., 0] * nrel[..., 1] - srel[..., 1] * nrel[..., 0]
    cross = np.where(idx < count[..., None], cross, 0.0)
    area = 0.5 * np.abs(cross.sum(-1))
    return np.where(count >= 3, area, 0.0)


@functools.cache
def _native_lib():
    lib = native.load_host("rotate_iou")
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rotate_iou_eval.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64, ctypes.c_int, dp]
    lib.rotate_iou_eval.restype = None
    return lib


def rotate_iou_eval(boxes, query_boxes, criterion: int = -1):
    """(N, 5) x (M, 5) -> (N, M) per `criterion` (see module docstring), by
    the C++ version (``csrc/rotate_iou.cc``), built at first use. A failed
    build raises: there is no fallback to ``rotate_iou_eval_np``, which is
    the plain version the tests hold it against."""
    lib = _native_lib()
    a = np.ascontiguousarray(boxes, np.float64).reshape(-1, 5)
    b = np.ascontiguousarray(query_boxes, np.float64).reshape(-1, 5)
    n, m = a.shape[0], b.shape[0]
    out = np.empty((n, m), np.float64)
    if n and m:
        dp = ctypes.POINTER(ctypes.c_double)
        lib.rotate_iou_eval(a.ctypes.data_as(dp), n, b.ctypes.data_as(dp), m,
                            int(criterion), out.ctypes.data_as(dp))
    return out


def rotate_iou_eval_np(boxes, query_boxes, criterion: int = -1):
    """Pure-numpy plain version of ``rotate_iou_eval``."""
    boxes = np.asarray(boxes, np.float64)
    query_boxes = np.asarray(query_boxes, np.float64)
    inter = _pairwise_intersection(_corners(boxes), _corners(query_boxes))
    area_a = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = (query_boxes[:, 2] * query_boxes[:, 3])[None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a, inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        return inter
    return np.where(denom > 0, inter / np.maximum(denom, _EPS), 0.0)
