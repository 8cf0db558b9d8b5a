"""RHGM: Radar Hybrid Generation Module — offline virtual point generation;
a copy of ``hgsfusion_tpu/rhgm/generator.py``, numpy on the host.

It stays numpy on purpose: its ``np.random.RandomState`` draws are the
output files' contract, and its kNN order is ``np.argsort`` (not stable)
over float32 ``np.linalg.norm`` distances between integer pixels, where
ties are common; a torch version would pick other depth sources.

Reference: hybrid_pts/hybrid_radar_pts_vod.py (add_virtual_mask:152-310,
projectionV2 / reverse_view_points in nusc_image_projection.py:16-91).
Semantics preserved:

- per instance mask, a probability map = sum of 51x51 sigma=7 Gaussians
  centered at the in-mask projected radar pixels (DOA-error model), masked to
  the instance (:169-200);
- num_virtual//2 pixels sampled with replacement proportional to that map,
  num_virtual//2 more uniformly from the remaining mask pixels (:202-216);
  masks with no radar hit sample purely uniformly (:211-213);
- depth for each virtual pixel is copied from its k-nearest (image-space,
  instance-isolated via a x1e4 id offset) in-mask radar points — k=1 for the
  Gaussian branch and k=4 for the uniform branch, each neighbor emitting its
  own virtual point (gauss_uniform_ratio=[1,4], loop :242-299);
- back-projection through the inverse intrinsics + extrinsics (:285-292).

Implementation is vectorized numpy over masks/pixels (the reference loops in
torch per point and per neighbor); the mask source is pluggable — the
reference bakes in Mask2Former, here any (M, H, W) instance masks + class
labels work (precomputed segmentation, gt-box rasterization for testing, ...).

Output layout matches what the dataset loader consumes
(vod_dataset.get_virtual_point:108-115):
  virtual_points: (N_v, 3 + C_radar_feats + 8) = [xyz | radar feats | one-hot]
  real_points:    (N_r, same) foreground radar points with their labels.
"""
from __future__ import annotations

import numpy as np


def gaussian_kernel(shape: int = 51, sigma: float = 7.0):
    m = (shape - 1) / 2.0
    y, x = np.ogrid[-m : m + 1, -m : m + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def project_points_to_image(points_xyz, lidar_to_cam, cam_to_img):
    """(N, 3) lidar -> (N, 3) [u, v, depth] + in-front validity."""
    n = points_xyz.shape[0]
    hom = np.concatenate([points_xyz, np.ones((n, 1), np.float32)], axis=1)
    cam = hom @ lidar_to_cam.T  # (N, 4)
    p = cam[:, :3] @ cam_to_img[:, :3].T + cam_to_img[:, 3]
    depth = p[:, 2]
    uv = p[:, :2] / np.clip(depth[:, None], 1e-6, None)
    valid = depth > 0.1
    return np.concatenate([uv, depth[:, None]], axis=1), valid


def back_project(uv, depth, lidar_to_cam, cam_to_img):
    """(N, 2) pixels + (N,) depths -> (N, 3) lidar points (reverse_view_points
    + inverse extrinsics, hybrid_radar_pts_vod.py:285-292)."""
    n = uv.shape[0]
    k = cam_to_img[:3, :3]
    # p = K [x y z]^T + t, with t = cam_to_img[:, 3]
    t = cam_to_img[:, 3]
    pix = np.concatenate([uv * depth[:, None], depth[:, None]], axis=1) - t
    cam = pix @ np.linalg.inv(k).T
    hom = np.concatenate([cam, np.ones((n, 1), np.float32)], axis=1)
    lidar = hom @ np.linalg.inv(lidar_to_cam).T
    return lidar[:, :3]


def generate_hybrid_points(masks, mask_labels, raw_points, lidar_to_cam,
                           cam_to_img, num_virtual: int = 100,
                           k_gauss: int = 1, k_uniform: int = 4,
                           gauss_shape: int = 51, gauss_sigma: float = 7.0,
                           dist_thresh: float = 3000.0, num_label_bins: int = 8,
                           rng=None):
    """One frame's RHGM output.

    masks: (M, H, W) bool instance masks; mask_labels: (M,) int in
    [0, num_label_bins); raw_points: (N, C) radar points (xyz + feats).
    Returns dict(virtual_points (Nv, 3+Cf+8), real_points (Nr, 3+Cf+8)).
    """
    rng = rng or np.random.RandomState(0)
    m = masks.shape[0]
    c_feats = raw_points.shape[1] - 3
    width = 3 + c_feats + num_label_bins
    empty = {
        "virtual_points": np.zeros((0, width), np.float32),
        "real_points": np.zeros((0, width), np.float32),
    }
    if m == 0 or raw_points.shape[0] == 0:
        return empty

    h, w = masks.shape[1:]
    uvd, in_front = project_points_to_image(
        raw_points[:, :3].astype(np.float32), lidar_to_cam, cam_to_img
    )
    # reference pixel convention (projectionV2, nusc_image_projection.py:
    # 78-82): FLOOR the projected coords and require strictly u > 0, v > 0
    ui = np.clip(np.floor(uvd[:, 0]).astype(np.int64), 0, w - 1)
    vi = np.clip(np.floor(uvd[:, 1]).astype(np.int64), 0, h - 1)
    in_img = (
        in_front & (np.floor(uvd[:, 0]) > 0) & (uvd[:, 0] < w)
        & (np.floor(uvd[:, 1]) > 0) & (uvd[:, 1] < h)
    )
    # point-in-mask matrix (N, M)
    in_mask = masks[:, vi, ui].T & in_img[:, None]
    fg = in_mask.any(axis=1)
    # each real point is ATTRIBUTED to its first containing mask (argmax,
    # hybrid_radar_pts_vod.py:230/162); the kNN isolation below matches
    # virtual pixels only against their own mask's attributed points —
    # overlapping masks must not share depth sources
    point_instance = np.argmax(in_mask, axis=1)  # valid where fg

    gk = gaussian_kernel(gauss_shape, gauss_sigma)
    r = gauss_shape // 2

    onehot = np.zeros((m, num_label_bins), np.float32)
    onehot[np.arange(m), np.clip(mask_labels, 0, num_label_bins - 1)] = 1.0

    virtual_rows = []
    n_half = num_virtual // 2
    for mi in range(m):
        mask = masks[mi]
        ys, xs = np.nonzero(mask)
        if len(ys) == 0:
            continue
        # kNN depth transfer is instance-isolated: only radar points
        # ATTRIBUTED to this mask can match (the reference's x1e4
        # instance-id offset over argmax-attributed ids). A mask with no
        # attributed points emits nothing (its isolated kNN distances all
        # exceed dist_thresh in the reference).
        hits = np.flatnonzero(fg & (point_instance == mi) & in_mask[:, mi])
        if len(hits) == 0:
            continue
        # Gaussian probability map from radar hits (DOA error model); the
        # reference's asymmetric slice [x-26 : x+25] puts the 51-kernel
        # peak one pixel up-left of the radar pixel
        # (hybrid_radar_pts_vod.py:181-195, round(25.5)=26)
        prob = np.zeros((h, w), np.float64)
        for pi in hits:
            y0, x0 = int(vi[pi]) - 1, int(ui[pi]) - 1
            y1, y2 = max(y0 - r, 0), min(y0 + r + 1, h)
            x1, x2 = max(x0 - r, 0), min(x0 + r + 1, w)
            prob[y1:y2, x1:x2] += gk[
                y1 - y0 + r : y2 - y0 + r, x1 - x0 + r : x2 - x0 + r
            ]
        base = prob[ys, xs] + 1e-6
        sel_gauss = rng.choice(len(ys), size=n_half, replace=True,
                               p=base / base.sum())
        uni = np.ones(len(ys))
        uni[sel_gauss] = 0.0
        n_uni = int(uni.sum())
        if n_uni == 0:
            sel_uni = sel_gauss[:0]
        else:
            sel_uni = rng.choice(
                len(ys), size=min(n_uni, n_half), replace=False,
                p=uni / uni.sum(),
            )
        sel = np.concatenate([sel_gauss, sel_uni])
        # pad to num_virtual by repeating the first selection; the pads
        # land in the uniform/k=4 block (hybrid_radar_pts_vod.py:214-216)
        # — small masks must still emit the full quota
        if len(sel) < num_virtual:
            sel = np.concatenate(
                [sel, np.full(num_virtual - len(sel), sel[0], np.int64)])
        branch = np.concatenate(
            [np.zeros(n_half, np.int64),
             np.ones(num_virtual - n_half, np.int64)]
        )
        vpix = np.stack([xs[sel], ys[sel]], axis=1).astype(np.float32)
        # distances against the FLOORED real-point pixels (projectionV2
        # stores floor()ed coords; the reference kNN runs on those)
        rpix = np.stack([ui[hits], vi[hits]], axis=1).astype(np.float32)
        d2 = np.linalg.norm(vpix[:, None, :] - rpix[None, :, :], axis=-1)
        order = np.argsort(d2, axis=1)
        for bi, k in ((0, k_gauss), (1, k_uniform)):
            bsel = branch == bi
            if not bsel.any():
                continue
            kk = min(k, len(hits))
            for j in range(kk):
                nn = order[bsel, j]
                nd = np.take_along_axis(d2[bsel], order[bsel, j : j + 1], axis=1)[:, 0]
                keep = nd < dist_thresh
                if not keep.any():
                    continue
                src = hits[nn[keep]]
                pix = vpix[bsel][keep]
                depth = uvd[src, 2]
                xyz = back_project(pix, depth, lidar_to_cam, cam_to_img)
                feats = raw_points[src, 3:]
                labels = np.broadcast_to(onehot[mi], (len(src), num_label_bins))
                virtual_rows.append(
                    np.concatenate([xyz, feats, labels], axis=1).astype(np.float32)
                )

    virtual_points = (
        np.concatenate(virtual_rows, axis=0) if virtual_rows
        else np.zeros((0, width), np.float32)
    )
    fg_idx = np.flatnonzero(fg)
    real_labels = onehot[point_instance[fg_idx]]
    real_points = np.concatenate(
        [raw_points[fg_idx].astype(np.float32), real_labels], axis=1
    )
    return {"virtual_points": virtual_points, "real_points": real_points}


def masks_from_gt_boxes2d(gt_boxes2d, gt_classes, image_hw):
    """Fallback mask source: rasterize 2D gt boxes into instance masks.

    Lets the RHGM pipeline run without an instance-segmentation model
    (testing / bootstrap); real deployments plug in precomputed masks.
    """
    h, w = image_hw
    masks = np.zeros((len(gt_boxes2d), h, w), bool)
    for i, b in enumerate(np.asarray(gt_boxes2d)):
        x1, y1, x2, y2 = [int(round(v)) for v in b]
        masks[i, max(y1, 0) : min(y2, h), max(x1, 0) : min(x2, w)] = True
    return masks, np.asarray(gt_classes, np.int64)
