"""Synthetic KITTI-format dataset generator (tests, benchmarks, demos): the
counterpart of ``hgsfusion_tpu/datasets/synthetic.py``, drawing from the same
``RandomState`` stream, so the same arguments write the same radar, label,
calib and virtual-point files. Images go through ``image_io``.

Creates a tiny on-disk tree with the exact layout VoD/TJ4D loaders expect
(velodyne/*.bin, image_2/*, calib/*.txt, label_2/*.txt, ImageSets/*.txt,
RHGM virtual-point .pkl.npy files), so the full data pipeline — including
hybrid-point merge, FOV filtering, augmentation, and info generation — is
exercisable without the real datasets. This replaces the reference's
untestable data layer (SURVEY.md §4: the reference has no fixtures at all).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .image_io import write_image


def make_calib(image_hw):
    """Intrinsics scaled to the synthetic image size; KITTI-like extrinsics
    (lidar x->cam z, lidar -y->cam x, lidar -z->cam y)."""
    h, w = image_hw
    f = 0.8 * w
    return {
        "P2": np.array(
            [[f, 0.0, w / 2, 0.02 * f], [0.0, f, h / 2, -0.01 * f],
             [0.0, 0.0, 1.0, 0.005]],
            np.float32,
        ),
        "R0": np.eye(3, dtype=np.float32),
        "Tr": np.array(
            [[0.0, -1.0, 0.0, 0.1], [0.0, 0.0, -1.0, -0.2], [1.0, 0.0, 0.0, 0.3]],
            np.float32,
        ),
    }


def _write_calib(path: Path, calib):
    def fmt(mat):
        return " ".join(f"{v:.6e}" for v in np.asarray(mat).reshape(-1))

    lines = [
        "P0: " + fmt(np.zeros((3, 4))),
        "P1: " + fmt(np.zeros((3, 4))),
        "P2: " + fmt(calib["P2"]),
        "P3: " + fmt(np.zeros((3, 4))),
        "R0_rect: " + fmt(calib["R0"]),
        "Tr_velo_to_cam: " + fmt(calib["Tr"]),
        "Tr_imu_to_velo: " + fmt(np.zeros((3, 4))),
    ]
    path.write_text("\n".join(lines) + "\n")


def _box_corners_bev(cx, cy, dx, dy, ry):
    """(4, 2) BEV corners of a rotated box (lidar frame)."""
    c, s = np.cos(ry), np.sin(ry)
    local = np.array(
        [[dx / 2, dy / 2], [dx / 2, -dy / 2], [-dx / 2, -dy / 2],
         [-dx / 2, dy / 2]])
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([cx, cy])


def _project_box_bbox(calib, box_lidar, image_hw, clamp_int=True):
    """2D bbox of a lidar box (cx cy cz dx dy dz heading) under the fixture
    calib: 8 corners -> camera -> P2 projection -> min/max, clamped."""
    cx, cy, cz, dx, dy, dz, heading = box_lidar
    bev = _box_corners_bev(cx, cy, dx, dy, heading)  # (4, 2)
    corners = np.concatenate(
        [np.repeat(bev, 2, axis=0),
         np.tile([[cz - dz / 2], [cz + dz / 2]], (4, 1))], axis=1)
    ones = np.ones((8, 1))
    cam = (calib["R0"] @ (calib["Tr"] @ np.hstack([corners, ones]).T)).T
    uvw = (calib["P2"] @ np.hstack([cam, ones]).T).T
    u, v = uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]
    h, w = image_hw
    bb = (max(u.min(), 0.0), max(v.min(), 0.0),
          min(u.max(), w - 1.0), min(v.max(), h - 1.0))
    if clamp_int:
        return tuple(int(round(c)) for c in bb)
    return bb


def _points_in_box(rng, n, box):
    """Uniform samples inside a rotated lidar box (cx cy cz dx dy dz ry)."""
    cx, cy, cz, dx, dy, dz, ry = box
    local = rng.uniform(-0.5, 0.5, (n, 3)) * np.array([dx, dy, dz])
    c, s = np.cos(ry), np.sin(ry)
    out = np.empty((n, 3), np.float32)
    out[:, 0] = cx + local[:, 0] * c - local[:, 1] * s
    out[:, 1] = cy + local[:, 0] * s + local[:, 1] * c
    out[:, 2] = cz + local[:, 2]
    return out


# nominal object sizes per class, (length, height, width) — anchor-set
# values from the shipped configs (hgsfusion_vod.yaml / hgsfusion_tj4d.yaml)
_DIMS_LHW = {
    "Car": (3.9, 1.56, 1.6),
    "Pedestrian": (0.8, 1.73, 0.6),
    "Cyclist": (1.76, 1.73, 0.6),
    "Truck": (10.76, 3.47, 2.66),
}


def make_synthetic_kitti(root, num_frames: int = 4, num_points: int = 256,
                         num_boxes: int = 3, num_virtual: int = 64,
                         image_hw=(128, 256), radar_channels: int = 7,
                         image_ext: str = ".jpg",
                         virtual_prefix: str = "virtual_points",
                         seed: int = 0, structured: bool = False,
                         classes=("Car", "Pedestrian", "Cyclist"),
                         support_range=None, frame_ids=None,
                         box_x0: float = 8.0, box_spread: float = 26.0):
    """Build the tree and return the root path.

    frame_ids: the frames' ids (default ``00000``, ``00001``, ...).
    box_x0, box_spread (structured mode): box b of ``num_boxes`` has its
    center's x drawn from [lo, lo + 4] m, lo = box_x0 + box_spread *
    b / num_boxes. The defaults, and any call that leaves out these three
    port-only arguments, write the JAX package's tree.

    structured=True makes the scenes LEARNABLE instead of white noise:
    radar/virtual points cluster inside the gt boxes with class-dependent
    feature signatures, virtual one-hot labels encode the true class, and
    the image shows a class-colored blob at each box's projection. A
    detector trained on these frames produces meaningful detections on a
    held-out split, which is what the detection-level polar-vs-gather
    equivalence study and the train->eval round trip need (white-noise
    frames admit only prior-fitting, so AP pins to ~0 and the comparison
    loses all resolution at the NMS/score boundary).

    support_range=(lo, hi) (structured mode only) scales each box's point
    support — its share of in-box radar AND virtual points — by a
    per-box log-uniform factor in [lo, hi], making objects range from
    fully supported to near-invisible. On uniformly easy scenes a trained
    detector reaches recall 1.0, where the 11-point AP has a 9.09-point
    cliff (the r=1.0 sample zeroes on the first missed gt) and AP deltas
    quantize to 0-or-9.09; a support gradient keeps every class in the
    PR-curve interior, so path/quantization ΔAP resolves smoothly below
    the 0.5-point north-star criterion. Factors come from a SEPARATE rng
    stream, so enabling this does not perturb existing fixtures' draws."""
    rng = np.random.RandomState(seed)
    support_rng = (np.random.RandomState(seed + 77003)
                   if support_range is not None else None)
    root = Path(root)
    training = root / "training"
    for sub in ("velodyne", "image_2", "depth_2", "calib", "label_2",
                virtual_prefix):
        (training / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)

    ids = ([f"{i:05d}" for i in range(num_frames)] if frame_ids is None
           else [str(i) for i in frame_ids])
    if len(ids) != num_frames:
        raise ValueError(f"{len(ids)} frame ids for {num_frames} frames")
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(ids) + "\n")

    h, w = image_hw
    calib = make_calib(image_hw)
    fx, cu = calib["P2"][0, 0], calib["P2"][0, 2]
    fy, cv = calib["P2"][1, 1], calib["P2"][1, 2]
    # horizontal half-FOV in lidar terms: |cam_x/cam_z| < cu/fx
    half_tan = 0.8 * cu / fx
    classes = list(classes)
    class_colors = np.array(
        [[220, 60, 60], [60, 220, 60], [60, 60, 220], [220, 220, 60]],
        np.uint8)
    if len(classes) > len(class_colors):
        raise ValueError("at most 4 classes supported in structured mode")
    for sid in ids:
        # gt boxes first (structured scenes hang everything off them):
        # lidar-frame (cx, cy, cz_center, l, h, w, ry) + class index.
        # Unstructured mode draws them inside the label loop below so the
        # rng stream (and therefore every existing fixture) is unchanged.
        frame_boxes = []
        if structured:
            for b in range(num_boxes):
                cls_i = b % len(classes)
                # spread centers along range so boxes never overlap
                lo = box_x0 + box_spread * b / max(num_boxes, 1)
                cx = rng.uniform(lo, lo + 4)
                cy = rng.uniform(-0.5, 0.5) * half_tan * cx
                cz = rng.uniform(-1.2, -0.4)
                dims_lhw = _DIMS_LHW.get(classes[cls_i], (0.8, 1.73, 0.6))
                ry = rng.uniform(-np.pi, np.pi)
                frame_boxes.append((cls_i, cx, cy, cz, dims_lhw, ry))
        if support_rng is not None and frame_boxes:
            lo, hi = support_range
            support = np.exp(support_rng.uniform(
                np.log(lo), np.log(hi), len(frame_boxes)))
        else:
            support = np.ones(max(len(frame_boxes), 1))

        # radar points in front of the sensor, inside the camera FOV
        pts = np.zeros((num_points, radar_channels), np.float32)
        pts[:, 0] = rng.uniform(3, 40, num_points)
        pts[:, 1] = rng.uniform(-half_tan, half_tan, num_points) * pts[:, 0]
        pts[:, 2] = rng.uniform(-1.5, 0.5, num_points)
        pts[:, 3:] = rng.randn(num_points, radar_channels - 3)
        if structured and frame_boxes:
            # ~half the returns come from the objects, with a strong
            # class-dependent rcs signature (col 3)
            n_obj = num_points // 2
            per = np.array_split(np.arange(n_obj), len(frame_boxes))
            for bi, ((cls_i, cx, cy, cz, (l, bh, bw), ry), idx) in enumerate(
                    zip(frame_boxes, per)):
                idx = idx[: int(round(len(idx) * support[bi]))]
                if len(idx) == 0:
                    continue
                # lidar box layout (x y z dx dy dz heading): dx=l, dy=w;
                # the label's ry is camera rotation_y, so the lidar
                # heading the reader will reconstruct is -(ry + pi/2)
                # (box_utils.boxes3d_kitti_camera_to_lidar) — scatter the
                # cluster with THAT heading so gt and points agree
                box = (cx, cy, cz, l, bw, bh, -(ry + np.pi / 2))
                pts[idx, 0:3] = _points_in_box(rng, len(idx), box)
                pts[idx, 3] = 4.0 + 2.0 * cls_i + 0.3 * rng.randn(len(idx))
        pts.tofile(training / "velodyne" / f"{sid}.bin")

        if structured:
            img = np.full((h, w, 3), 96, np.uint8)
            img += (8 * rng.rand(h, w, 3)).astype(np.uint8)
            # class-colored blob at each box's image projection (the
            # camera branch's learnable signal)
            for bi, (cls_i, cx, cy, cz, (l, bh, bw), ry) in enumerate(
                    frame_boxes):
                u0, v0, u1, v1 = _project_box_bbox(
                    calib, (cx, cy, cz, l, bw, bh, -(ry + np.pi / 2)),
                    (h, w))
                if u1 > u0 and v1 > v0:
                    # blob contrast follows the box's support factor so a
                    # weak-radar object is not rescued by a full-strength
                    # camera signature (support=1.0 reproduces the old
                    # hard assignment exactly)
                    blob = (support[bi] * class_colors[cls_i]
                            + (1.0 - support[bi]) * img[v0:v1, u0:u1])
                    img[v0:v1, u0:u1] = blob.astype(np.uint8)
        else:
            img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        write_image(training / "image_2" / f"{sid}{image_ext}", img)

        # gt depth map: uint16 png at 1/256 m (vod get_depth_map convention)
        depth = rng.uniform(1.0, 50.0, (h, w)).astype(np.float32)
        write_image(training / "depth_2" / f"{sid}.png", (depth * 256.0).astype(np.uint16))

        _write_calib(training / "calib" / f"{sid}.txt", calib)

        # labels: put boxes near some points so targets exist
        lines = []
        for b in range(num_boxes):
            if structured:
                cls_i, cx, cy, cz, dims_lhw, ry = frame_boxes[b]
                cls = classes[cls_i]
            else:
                cls = classes[b % len(classes)]
                cx = rng.uniform(8, 30)
                cy = rng.uniform(-0.5, 0.5) * half_tan * cx
                cz = rng.uniform(-1.2, -0.4)
                if cls == "Car":
                    dims_lhw = (3.9, 1.56, 1.6)
                else:
                    dims_lhw = (0.8, 1.73, 0.6)
                ry = rng.uniform(-np.pi, np.pi)
            # lidar -> camera: cam x = -y + .1, cam y = -z - .2, cam z = x + .3
            cam_x, cam_y, cam_z = -cy + 0.1, -cz - 0.2, cx + 0.3
            cam_y += dims_lhw[1] / 2  # label y is the box bottom in camera
            if structured:
                bb = _project_box_bbox(
                    calib,
                    (cx, cy, cz, dims_lhw[0], dims_lhw[2], dims_lhw[1],
                     -(ry + np.pi / 2)),
                    (h, w), clamp_int=False)
            else:
                u = fx * cam_x / cam_z + cu
                v = fy * cam_y / cam_z + cv
                bb = (
                    max(u - 20, 0), max(v - 20, 0),
                    min(u + 20, w - 1), min(v + 20, h - 1),
                )
            lines.append(
                f"{cls} 0.00 0 0.0 {bb[0]:.2f} {bb[1]:.2f} {bb[2]:.2f} "
                f"{bb[3]:.2f} {dims_lhw[1]:.2f} {dims_lhw[2]:.2f} "
                f"{dims_lhw[0]:.2f} {cam_x:.2f} {cam_y:.2f} {cam_z:.2f} {ry:.2f}"
            )
        (training / "label_2" / f"{sid}.txt").write_text("\n".join(lines) + "\n")

        # RHGM-style virtual point file: (N, base+8) with one-hot labels
        d = radar_channels + 8
        virtual = np.zeros((num_virtual, d), np.float32)
        virtual[:, 0] = rng.uniform(3, 40, num_virtual)
        virtual[:, 1] = rng.uniform(-half_tan, half_tan, num_virtual) * virtual[:, 0]
        virtual[:, 2] = rng.uniform(-1.5, 0.5, num_virtual)
        virtual[:, 3:radar_channels] = rng.randn(num_virtual, radar_channels - 3)
        onehot = rng.randint(0, 8, num_virtual)
        virtual[np.arange(num_virtual), radar_channels + onehot] = 1.0
        if structured and frame_boxes:
            # RHGM densifies objects: most virtual points live inside the
            # boxes with a TRUE-class one-hot (slot = class index) and the
            # same rcs signature as the real in-box returns
            n_obj = (3 * num_virtual) // 4
            per = np.array_split(np.arange(n_obj), len(frame_boxes))
            for bi, ((cls_i, cx, cy, cz, (l, bh, bw), ry), idx) in enumerate(
                    zip(frame_boxes, per)):
                idx = idx[: int(round(len(idx) * support[bi]))]
                if len(idx) == 0:
                    continue
                box = (cx, cy, cz, l, bw, bh, -(ry + np.pi / 2))
                virtual[idx, 0:3] = _points_in_box(rng, len(idx), box)
                virtual[idx, 3] = (4.0 + 2.0 * cls_i
                                   + 0.3 * rng.randn(len(idx)))
                virtual[idx, radar_channels:] = 0.0
                virtual[idx, radar_channels + cls_i] = 1.0
        n_gt_real = max(num_virtual // 8, 1)
        gt_real = virtual[:n_gt_real].copy()
        np.save(
            training / virtual_prefix / f"{sid}.pkl",
            {"virtual_points": virtual, "real_points": gt_real},
            allow_pickle=True,
        )
    return root


# TJ4DRadSet sequences (datasets/tj4d.py's WEATHER_FILTER groups: dark,
# standard, shiny) and one in none of them
TJ4D_SEQUENCES = (0, 5, 30, 77, 1, 10, 31, 20, 34, 23, 37, 41)


def make_synthetic_tj4d(root, num_frames: int = 4, num_points: int = 256,
                        num_virtual: int = 64, image_hw=(810, 1280), seed: int = 0,
                        virtual_prefix: str = "virtual_points", num_boxes: int = 6,
                        box_x0: float = 10.0, box_spread: float = 70.0):
    """A structured TJ4DRadSet-format tree: 8 radar channels, PNG images,
    six-digit frame ids whose first two digits cycle through
    ``TJ4D_SEQUENCES`` (so every weather group holds frames, and one
    sequence lies in none), and ``num_boxes`` boxes a frame, Car,
    Pedestrian, Cyclist, Truck in turn, by default six from 10 m out to past
    70 m, so every range difficulty holds boxes."""
    ids = [f"{TJ4D_SEQUENCES[i % len(TJ4D_SEQUENCES)]:02d}{i:04d}" for i in range(num_frames)]
    return make_synthetic_kitti(
        root, num_frames=num_frames, num_points=num_points, num_boxes=num_boxes,
        num_virtual=num_virtual, image_hw=image_hw, radar_channels=8, image_ext=".png",
        virtual_prefix=virtual_prefix, seed=seed, structured=True,
        classes=("Car", "Pedestrian", "Cyclist", "Truck"), frame_ids=ids,
        box_x0=box_x0, box_spread=box_spread)
