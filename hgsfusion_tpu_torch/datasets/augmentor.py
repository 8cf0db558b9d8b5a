"""Training-time augmentations (counterpart of
``hgsfusion_tpu/datasets/augmentor.py``), numpy, on the host.

The ported ops: the world flip, rotation, scaling and translation; the image
flip that follows the world flip and the standalone one; the per-box
(local) translation, rotation and scaling; the world and local frustum
dropouts; the SE-SSD pyramid augmentation; and ``imgaug``, the multi-camera
flip and rotation (``scipy.ndimage``, imported at the call). Every op draws
from the global ``np.random`` stream in the JAX package's order, so the same
seed gives the same frames. ``gt_sampling`` (the database sampler) and the
proposal / velocity boxes are ROADMAP.md queue 1 item 9: a config that names
the first and does not disable it raises at construction. The boxes are the
7-column lidar boxes (x, y, z, dx, dy, dz, heading); the class column is
appended after the augmentor (``DatasetTemplate.prepare_data``).

Reference: pcdet/datasets/augmentor/data_augmentor.py and augmentor_utils.py.
"""
from __future__ import annotations

import numpy as np

from ..utils.box_utils import boxes_to_corners_3d, rotate_points_along_z_np

PORTED = ("random_world_flip", "random_image_flip_fusion", "random_world_rotation",
          "random_world_scaling", "random_world_translation", "random_local_translation",
          "random_local_rotation", "random_local_scaling", "random_world_frustum_dropout",
          "random_local_frustum_dropout", "random_local_pyramid_aug", "random_image_flip",
          "imgaug")

# box-face quads in the corner template's order, each (c0, c1, c2, c3) with
# c1 and c3 next to c0, so a pyramid's edge vectors are orthogonal: bottom,
# top, +x, -x, +y, -y
_PYRAMID_FACES = np.array([
    [0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 5, 4],
    [3, 2, 6, 7], [0, 3, 7, 4], [1, 2, 6, 5],
])


def _box_pyramids(boxes):
    """(N, 7+) -> (N, 6, 5, 3): per face [apex = box center | 4 corners]."""
    boxes = np.asarray(boxes)
    faces = boxes_to_corners_3d(boxes[:, :7])[:, _PYRAMID_FACES]  # (N, 6, 4, 3)
    apex = np.broadcast_to(boxes[:, None, None, :3], (len(boxes), 6, 1, 3))
    return np.concatenate([apex, faces], axis=2)


def _pyramid_basis(pyr):
    """(face center, the two face edges from c0, face center -> apex)."""
    sc = pyr[1:5].mean(axis=0)
    return sc, pyr[2] - pyr[1], pyr[4] - pyr[1], pyr[0] - sc


def _pyramid_coords(points, pyr):
    """A point's (alpha, beta, gamma) in a face pyramid: alpha / beta along
    the face edges from c0, gamma from the face center to the apex (exact
    projections: the three vectors are orthogonal for box faces)."""
    sc, v0, v1, v2 = _pyramid_basis(pyr)
    rel = points[:, :3] - pyr[1]
    a = rel @ v0 / max(v0 @ v0, 1e-9)
    b = rel @ v1 / max(v1 @ v1, 1e-9)
    g = (points[:, :3] - sc) @ v2 / max(v2 @ v2, 1e-9)
    return a, b, g


def _in_pyramid(points, pyr):
    """Inside a face pyramid: its cross-section is the face scaled by
    (1 - gamma) about its center."""
    a, b, g = _pyramid_coords(points, pyr)
    half = (1.0 - g) / 2.0
    return (g >= 0) & (g <= 1) & (np.abs(a - 0.5) <= half) & (np.abs(b - 0.5) <= half)


def _remap_pyramid_points(points, src_pyr, dst_pyr, dst_int_range=None):
    """Points carried from one pyramid to another by their (alpha, beta,
    gamma); the last (intensity) column's min-max ratios rescaled into the
    receiving pyramid's range (the span clipped to [1e-6, 1], as the
    reference clips it)."""
    out = points.copy()
    a, b, g = _pyramid_coords(points, src_pyr)
    sc, v0, v1, v2 = _pyramid_basis(dst_pyr)
    out[:, :3] = (a[:, None] * v0 + b[:, None] * v1) + dst_pyr[1] + g[:, None] * v2
    if points.shape[1] > 3 and len(points) and dst_int_range is not None:
        inten = points[:, -1]
        lo, hi = inten.min(), inten.max()
        ratio = (inten - lo) / np.clip(hi - lo, 1e-6, 1.0)
        dlo, dhi = dst_int_range
        out[:, -1] = ratio * (dhi - dlo) + dlo
    return out


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        disable = set(augmentor_configs.get("DISABLE_AUG_LIST", []))
        self.queue = []
        for cfg in augmentor_configs["AUG_CONFIG_LIST"]:
            name = cfg["NAME"]
            if name in disable:
                continue
            if name not in PORTED:
                raise NotImplementedError(
                    f"DATA_AUGMENTOR: {name} is not ported (ROADMAP.md queue 1 item 9, the "
                    f"database sampler); list it in DISABLE_AUG_LIST or use "
                    f"{', '.join(PORTED)}")
            self.queue.append((getattr(self, name), cfg))

    # -- individual augmentations -------------------------------------------
    @staticmethod
    def _flip_boxes(boxes, axis):
        """In-place flip of (N, 7) boxes: across the x axis negates y and the
        heading, across the y axis negates x and maps the heading to
        -(heading + pi)."""
        if axis == "x":
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
        else:
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = -(boxes[:, 6] + np.pi)

    def random_world_flip(self, data_dict, config):
        for axis in config["ALONG_AXIS_LIST"]:
            if axis not in ("x", "y"):
                raise ValueError(f"random_world_flip: axis {axis!r}")
            enable = bool(np.random.choice([False, True]))
            if enable:
                self._flip_boxes(data_dict["gt_boxes"], axis)
                col = 1 if axis == "x" else 0
                data_dict["points"][:, col] = -data_dict["points"][:, col]
            data_dict[f"flip_{axis}"] = enable
        return data_dict

    def random_world_rotation(self, data_dict, config):
        rot_range = config["WORLD_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        noise_rot = np.random.uniform(rot_range[0], rot_range[1])
        angle = np.array([noise_rot])
        data_dict["points"] = rotate_points_along_z_np(data_dict["points"][None], angle)[0]
        gt = data_dict["gt_boxes"]
        gt[:, 0:3] = rotate_points_along_z_np(gt[None, :, 0:3], angle)[0]
        gt[:, 6] += noise_rot
        data_dict["noise_rot"] = noise_rot
        return data_dict

    def random_world_scaling(self, data_dict, config):
        lo, hi = config["WORLD_SCALE_RANGE"]
        if hi - lo < 1e-3:
            return data_dict
        scale = np.random.uniform(lo, hi)
        data_dict["points"][:, :3] *= scale
        data_dict["gt_boxes"][:, :6] *= scale
        data_dict["noise_scale"] = scale
        return data_dict

    def random_world_translation(self, data_dict, config):
        """A Gaussian shift of the world, recorded as ``noise_translate``
        (the aug matrix's translation column)."""
        std = config["NOISE_TRANSLATE_STD"]
        noise = np.array([np.random.normal(0, std[0]), np.random.normal(0, std[1]),
                          np.random.normal(0, std[2])], np.float32)
        data_dict["points"][:, :3] += noise
        data_dict["gt_boxes"][:, :3] += noise
        data_dict["noise_translate"] = noise
        return data_dict

    @staticmethod
    def _in_box_mask(points, box):
        """The points in a rotated box: inclusive half extents, with a 0.1 m
        margin in x and y so that points on the boundary move with the box."""
        margin = 1e-1
        sx, sy, sz = points[:, 0] - box[0], points[:, 1] - box[1], points[:, 2] - box[2]
        cosa, sina = np.cos(-box[6]), np.sin(-box[6])
        local_x = sx * cosa - sy * sina
        local_y = sx * sina + sy * cosa
        return ((np.abs(sz) <= box[5] / 2.0) & (np.abs(local_x) <= box[3] / 2.0 + margin)
                & (np.abs(local_y) <= box[4] / 2.0 + margin))

    def random_local_translation(self, data_dict, config):
        """Per axis, per box, a uniform shift of the box and its points."""
        gt, pts = data_dict["gt_boxes"], data_dict["points"]
        lo, hi = config["LOCAL_TRANSLATION_RANGE"]
        for axis in config["ALONG_AXIS_LIST"]:
            col = {"x": 0, "y": 1, "z": 2}[axis]
            for idx in range(len(gt)):
                offset = np.random.uniform(lo, hi)
                mask = self._in_box_mask(pts, gt[idx])
                pts[mask, col] += offset
                gt[idx, col] += offset
        return data_dict

    def random_local_rotation(self, data_dict, config):
        """Per box, a uniform rotation of the box and its points about its
        center."""
        rot_range = config["LOCAL_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        gt, pts = data_dict["gt_boxes"], data_dict["points"]
        for idx in range(len(gt)):
            rot = np.random.uniform(rot_range[0], rot_range[1])
            mask = self._in_box_mask(pts, gt[idx])
            center = gt[idx, :3].copy()
            pts[mask, :3] -= center
            pts[mask] = rotate_points_along_z_np(pts[None, mask], np.array([rot]))[0]
            pts[mask, :3] += center
            gt[idx, 6] += rot
        return data_dict

    def random_local_scaling(self, data_dict, config):
        """Per box, a uniform scaling of the box and its points about its
        center."""
        lo, hi = config["LOCAL_SCALE_RANGE"]
        if hi - lo < 1e-3:
            return data_dict
        gt, pts = data_dict["gt_boxes"], data_dict["points"]
        for idx in range(len(gt)):
            scale = np.random.uniform(lo, hi)
            mask = self._in_box_mask(pts, gt[idx])
            center = gt[idx, :3].copy()
            pts[mask, :3] = (pts[mask, :3] - center) * scale + center
            gt[idx, 3:6] *= scale
        return data_dict

    def random_world_frustum_dropout(self, data_dict, config):
        """Per direction, drop the points and boxes beyond a uniform fraction
        of the cloud's extent (top / bottom along z, left / right along y)."""
        gt, pts = data_dict["gt_boxes"], data_dict["points"]
        lo, hi = config["INTENSITY_RANGE"]
        for direction in config["DIRECTION"]:
            if len(pts) == 0:
                break
            intensity = np.random.uniform(lo, hi)
            col = 2 if direction in ("top", "bottom") else 1
            vmin, vmax = pts[:, col].min(), pts[:, col].max()
            if direction in ("top", "left"):
                thr = vmax - intensity * (vmax - vmin)
                keep_p, keep_b = pts[:, col] < thr, gt[:, col] < thr
            else:
                thr = vmin + intensity * (vmax - vmin)
                keep_p, keep_b = pts[:, col] > thr, gt[:, col] > thr
            pts = pts[keep_p]
            if "gt_boxes_mask" in data_dict:
                data_dict["gt_boxes_mask"] = data_dict["gt_boxes_mask"][keep_b]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][keep_b]
            if data_dict.get("gt_boxes2d", None) is not None and len(
                    data_dict["gt_boxes2d"]) == len(gt):
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][keep_b]
            gt = gt[keep_b]
        data_dict["points"] = pts
        data_dict["gt_boxes"] = gt
        return data_dict

    def random_local_frustum_dropout(self, data_dict, config):
        """Per direction, per box, drop the box's points beyond a uniform
        fraction of its extent."""
        gt, pts = data_dict["gt_boxes"], data_dict["points"]
        lo, hi = config["INTENSITY_RANGE"]
        for direction in config["DIRECTION"]:
            for idx in range(len(gt)):
                if len(pts) == 0:
                    break
                _, y, z, _, dy, dz = gt[idx, :6]
                intensity = np.random.uniform(lo, hi)
                mask = self._in_box_mask(pts, gt[idx])
                if direction == "top":
                    drop = mask & (pts[:, 2] >= (z + dz / 2) - intensity * dz)
                elif direction == "bottom":
                    drop = mask & (pts[:, 2] <= (z - dz / 2) + intensity * dz)
                elif direction == "left":
                    drop = mask & (pts[:, 1] >= (y + dy / 2) - intensity * dy)
                else:
                    drop = mask & (pts[:, 1] <= (y - dy / 2) + intensity * dy)
                pts = pts[~drop]
        data_dict["points"] = pts
        return data_dict

    def random_local_pyramid_aug(self, data_dict, config):
        """SE-SSD's pyramid augmentations: each box splits into 6 face
        pyramids (apex at the box center); per box one random pyramid may be
        dropped (its points deleted), sparsified (subsampled to
        SPARSIFY_MAX_NUM when richer) or swapped with another box's pyramid
        of the same face (the points carried over by their in-pyramid
        coordinates, the intensities rescaled into the receiving range). A
        box takes part in one stage at most."""
        gt, pts = data_dict["gt_boxes"], data_dict["points"]
        if len(gt) == 0:
            return data_dict
        pyramids = _box_pyramids(gt)

        face = np.random.randint(0, 6, len(pyramids))  # dropout
        drop = np.random.uniform(0, 1, len(pyramids)) <= config["DROP_PROB"]
        if drop.any() and len(pts):
            masks = [_in_pyramid(pts, pyramids[i, face[i]]) for i in np.where(drop)[0]]
            pts = pts[~np.any(masks, axis=0)]
        pyramids = pyramids[~drop]

        if len(pyramids) and len(pts):  # sparsify
            maxn = int(config["SPARSIFY_MAX_NUM"])
            face = np.random.randint(0, 6, len(pyramids))
            sp = np.random.uniform(0, 1, len(pyramids)) <= config["SPARSIFY_PROB"]
            remove = np.zeros(len(pts), bool)
            kept_parts = []
            for i in np.where(sp)[0]:
                mask = _in_pyramid(pts, pyramids[i, face[i]])
                if mask.sum() > maxn:
                    remove |= mask
                    sel = np.random.choice(np.where(mask)[0], size=maxn, replace=False)
                    kept_parts.append(pts[sel])
            if remove.any():
                pts = np.concatenate([pts[~remove]] + kept_parts)
            pyramids = pyramids[~sp]

        if len(pyramids) > 1 and len(pts):  # swap
            thres = int(config["SWAP_MAX_NUM"])
            swap = np.random.uniform(0, 1, len(pyramids)) <= config["SWAP_PROB"]
            if swap.any():
                counts = np.stack([[_in_pyramid(pts, pyramids[i, j]).sum() for j in range(6)]
                                   for i in range(len(pyramids))])
                rich = counts > thres
                pairs = []
                taken = np.zeros_like(rich)
                for i in np.where(swap)[0]:
                    js = np.where(rich[i] & ~taken[i])[0]
                    if not len(js):
                        continue
                    j = np.random.choice(js)
                    donors = np.where(rich[:, j] & ~taken[:, j]
                                      & (np.arange(len(pyramids)) != i))[0]
                    if not len(donors):
                        continue  # the reference's swap with itself changes nothing
                    d = np.random.choice(donors)
                    taken[i, j] = taken[d, j] = True
                    pairs.append((i, d, j))
                if pairs:
                    remove = np.zeros(len(pts), bool)
                    new_parts = []
                    for i, d, j in pairs:
                        m_i = _in_pyramid(pts, pyramids[i, j])
                        m_d = _in_pyramid(pts, pyramids[d, j])
                        remove |= m_i | m_d
                        rng_i = (pts[m_i, -1].min(), pts[m_i, -1].max())
                        rng_d = (pts[m_d, -1].min(), pts[m_d, -1].max())
                        new_parts.append(_remap_pyramid_points(
                            pts[m_d], pyramids[d, j], pyramids[i, j], rng_i))
                        new_parts.append(_remap_pyramid_points(
                            pts[m_i], pyramids[i, j], pyramids[d, j], rng_d))
                    pts = np.concatenate([pts[~remove]] + new_parts)
        data_dict["points"] = pts
        return data_dict

    def _flip_image_with_boxes(self, data_dict):
        """Horizontal image flip: each box centre is flipped in image space
        and lifted back through the calibration, so camera and lidar stay
        aligned; the heading is negated and the 2-D boxes mirrored."""
        image = data_dict["images"]
        calib = data_dict["calib"]
        gt = data_dict["gt_boxes"]
        data_dict["images"] = np.ascontiguousarray(np.fliplr(image))
        w = image.shape[1]
        img_pts, img_depth = calib.lidar_to_img(gt[:, :3])
        img_pts[:, 0] = w - img_pts[:, 0]
        pts_rect = calib.img_to_rect(u=img_pts[:, 0], v=img_pts[:, 1], depth_rect=img_depth)
        gt[:, :3] = calib.rect_to_lidar(pts_rect)
        gt[:, 6] = -gt[:, 6]
        if data_dict.get("gt_boxes2d", None) is not None and len(data_dict["gt_boxes2d"]):
            b2d = data_dict["gt_boxes2d"]
            b2d[:, [0, 2]] = w - b2d[:, [2, 0]]
        for key in ("foreground", "depth_maps"):
            if key in data_dict:
                data_dict[key] = np.ascontiguousarray(np.fliplr(data_dict[key]))
        return data_dict

    def random_image_flip_fusion(self, data_dict, config):
        """Flip the image iff the world was flipped along x."""
        if not data_dict.get("flip_x", False):
            return data_dict
        return self._flip_image_with_boxes(data_dict)

    def random_image_flip(self, data_dict, config):
        """A horizontal image flip with probability PROB (0.5), the boxes
        moved with it."""
        prob = float(config.get("PROB", 0.5))
        for axis in config.get("ALONG_AXIS_LIST", ["horizontal"]):
            if axis != "horizontal":
                raise ValueError(f"random_image_flip: axis {axis!r}")
            if np.random.choice([False, True], replace=False, p=[1.0 - prob, prob]):
                data_dict = self._flip_image_with_boxes(data_dict)
        return data_dict

    def imgaug(self, data_dict, config):
        """Per camera of ``camera_imgs``, a flip (with RAND_FLIP) and a
        uniform rotation in ROT_LIM degrees about the image center, recorded
        in ``img_process_infos`` ([resize, crop, flip, rotate] per camera)."""
        imgs = data_dict.get("camera_imgs")
        if imgs is None:
            return data_dict
        imgs = np.asarray(imgs)
        infos = data_dict.get("img_process_infos")
        if infos is None:
            h, w = imgs.shape[1:3]
            infos = [[1.0, (0, 0, w, h), False, 0.0] for _ in range(len(imgs))]
            data_dict["img_process_infos"] = infos
        rot_lim = config.get("ROT_LIM", [0.0, 0.0])
        rand_flip = bool(config.get("RAND_FLIP", False))
        new_imgs = []
        for img, info in zip(imgs, infos):
            flip = bool(rand_flip and np.random.choice([0, 1]))
            rotate = float(np.random.uniform(rot_lim[0], rot_lim[1]))
            if flip:
                img = img[:, ::-1]
            if abs(rotate) > 1e-6:
                img = self._rotate_image(img, rotate)
            info[2] = flip
            info[3] = rotate
            new_imgs.append(np.ascontiguousarray(img))
        data_dict["camera_imgs"] = np.stack(new_imgs)
        return data_dict

    @staticmethod
    def _rotate_image(img, rotate_deg):
        """Rotation about the image center, bilinear, zeros outside:
        output(q) = input(a^-1 (q - b) + b) with a = [[cos, sin], [-sin, cos]]
        on (u, v) and b the center."""
        from scipy import ndimage

        theta = rotate_deg / 180.0 * np.pi
        c, s = np.cos(theta), np.sin(theta)
        h, w = img.shape[:2]
        b_uv = np.array([w, h], np.float64) / 2
        a_inv_uv = np.array([[c, -s], [s, c]], np.float64)
        t_uv = b_uv - a_inv_uv @ b_uv
        # ndimage indexes (row = v, col = u)
        m_vu = np.array([[a_inv_uv[1, 1], a_inv_uv[1, 0]], [a_inv_uv[0, 1], a_inv_uv[0, 0]]])
        off_vu = np.array([t_uv[1], t_uv[0]])

        def warp(plane):
            return ndimage.affine_transform(plane.astype(np.float32), m_vu, offset=off_vu,
                                            order=1, mode="constant", cval=0.0)

        out = (np.stack([warp(img[..., ch]) for ch in range(img.shape[2])], axis=-1)
               if img.ndim == 3 else warp(img))
        return out.astype(img.dtype) if np.issubdtype(img.dtype, np.integer) else out

    def forward(self, data_dict):
        """Apply the queue, wrap each heading into [-pi, pi), then keep the
        boxes of ``gt_boxes_mask`` (their names and 2-D boxes too)."""
        if "roi_boxes" in data_dict or data_dict["gt_boxes"].shape[1] > 7:
            raise NotImplementedError(
                "the port's augmentor takes 7-column lidar boxes without roi_boxes "
                "(velocity and proposal boxes are ROADMAP.md queue 1 item 9)")
        for fn, cfg in self.queue:
            data_dict = fn(data_dict, cfg)
        gt = data_dict["gt_boxes"]
        if len(gt):
            gt[:, 6] = gt[:, 6] - np.floor(gt[:, 6] / (2 * np.pi) + 0.5) * 2 * np.pi
        data_dict.pop("road_plane", None)
        if "gt_boxes_mask" in data_dict:
            mask = data_dict.pop("gt_boxes_mask")
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            data_dict["gt_names"] = data_dict["gt_names"][mask]
            if data_dict.get("gt_boxes2d", None) is not None:
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][mask]
        return data_dict
