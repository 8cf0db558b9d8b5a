"""Shared rendering of frames and results with matplotlib (counterpart of
``hgsfusion_tpu/utils/visual.py``).

The drawing follows the reference's visual_tools scripts: translucent
six-face 3-D boxes projected into the camera image, stroke-outlined point
circles and rotated BEV rectangles, per-class colors and a 0.4 score
threshold. ``tools/demo.py`` draws with ``draw_bev`` and
``draw_image_boxes``; ``render_results`` renders a ``result.pkl`` of
``tools/test.py``. matplotlib is imported where a figure is drawn, never
when this module is imported.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .box_utils import boxes_to_corners_3d as _corners

# BEV corner template, counter-clockwise for heading 0
_CORNER_TEMPLATE_BEV = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=np.float32) / 2.0

# per-class face colors (visual_result_vod_graps.py:269-276)
CLASS_COLORS = {
    "Car": (0.494, 0.184, 0.556),
    "Pedestrian": (82 / 255, 141 / 255, 232 / 255),
    "Cyclist": (173 / 255, 216 / 255, 230 / 255),
    "Truck": (0.85, 0.54, 0.2),  # TJ4D's 4th class
}
GT_COLOR = (0.494, 0.184, 0.556)
REAL_POINT_COLOR = (92 / 255, 156 / 255, 255 / 255)
VIRTUAL_POINT_COLOR = (248 / 255, 203 / 255, 173 / 255)


def boxes_to_corners_3d(boxes):
    """(N, 7) lidar boxes -> (N, 8, 3) corners (common_utils template)."""
    return _corners(np.asarray(boxes, np.float32))


def lidar_to_img(points, lidar2cam, cam2img):
    """(N, 3) -> (N, 3) [u, v, depth] (visual_result_*.py lidar2img)."""
    hom = np.concatenate(
        [points[:, :3], np.ones((len(points), 1))], axis=1)
    cam = (lidar2cam @ hom.T).T[:, :3]
    depth = cam[:, 2]
    img = (cam2img[:3, :3] @ cam.T).T
    img = img / img[:, 2:3]
    return np.concatenate([img[:, :2], depth[:, None]], axis=1)


def boxes_to_corners_bev(boxes):
    """(..., 7) boxes -> (..., 4, 2) counter-clockwise BEV corners."""
    dxy = boxes[..., None, 3:5] * _CORNER_TEMPLATE_BEV
    cosa = np.cos(boxes[..., 6])[..., None]
    sina = np.sin(boxes[..., 6])[..., None]
    x = dxy[..., 0] * cosa - dxy[..., 1] * sina
    y = dxy[..., 0] * sina + dxy[..., 1] * cosa
    return np.stack([x, y], axis=-1) + boxes[..., None, 0:2]


def draw_bev(ax, points, boxes=None, labels=None, scores=None, color="lime",
             pc_range=(0, -25.6, 51.2, 25.6)):
    """Points as white dots, boxes as BEV rings with their scores, on
    black, over ``pc_range`` (x0, y0, x1, y1)."""
    ax.scatter(points[:, 0], points[:, 1], s=0.4, c="white", alpha=0.6)
    if boxes is not None and len(boxes):
        for i, c in enumerate(boxes_to_corners_bev(np.asarray(boxes))):
            ring = np.concatenate([c, c[:1]], axis=0)
            ax.plot(ring[:, 0], ring[:, 1], color=color, linewidth=0.8)
            if scores is not None:
                ax.text(c[0, 0], c[0, 1], f"{scores[i]:.2f}", color=color, fontsize=5)
    ax.set_facecolor("black")
    ax.set_xlim(pc_range[0], pc_range[2])
    ax.set_ylim(pc_range[1], pc_range[3])
    ax.set_aspect("equal")


def draw_image_boxes(ax, image, boxes, calib, color="lime", scores=None, show_image=True):
    """Project 3-D boxes into the camera image and draw their 12 edges; a
    box at or behind the camera, or wholly outside the image, is skipped."""
    if show_image:
        ax.imshow(image.astype("uint8") if image.max() > 1.5 else image)
    if boxes is None or not len(boxes):
        return
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    h, w = image.shape[:2]
    for bi, c in enumerate(boxes_to_corners_3d(boxes)):
        uv, depth = calib.lidar_to_img(c)
        if (depth <= 0.5).any():
            continue
        if ((uv[:, 0] < 0) | (uv[:, 0] >= w) | (uv[:, 1] < 0) | (uv[:, 1] >= h)).all():
            continue
        for a, b in edges:
            ax.plot([uv[a, 0], uv[b, 0]], [uv[a, 1], uv[b, 1]], color=color, linewidth=0.8)
        if scores is not None:
            ax.text(uv[0, 0], uv[0, 1], f"{scores[bi]:.2f}", color=color, fontsize=5)
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.set_axis_off()


def draw_boxes_image(ax, boxes_lidar, lidar2cam, cam2img, colors,
                     alpha=0.2):
    """Translucent 6-face rendering of 3D boxes in image space."""
    faces = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (1, 2, 6, 5),
             (2, 3, 7, 6), (0, 3, 7, 4))
    for box, color in zip(np.asarray(boxes_lidar), colors):
        corners = boxes_to_corners_3d(box[None, :7])[0]
        pts = lidar_to_img(corners, lidar2cam, cam2img)
        if (pts[:, 2] <= 0.1).any():
            continue  # behind the camera
        for f in faces:
            ax.fill(pts[list(f), 0], pts[list(f), 1], color=color,
                    alpha=alpha)


def draw_points_bev(ax, points, facecolor, radius=0.2, stroke=1.0):
    """Stroke-outlined circles per point (the reference's Circle loop)."""
    import matplotlib.patheffects as pe
    from matplotlib import pyplot as plt

    for x, y in np.asarray(points)[:, :2]:
        c = plt.Circle((x, y), radius, facecolor=facecolor)
        ax.add_artist(c)
        c.set_path_effects(
            [pe.Stroke(linewidth=stroke, foreground="black"), pe.Normal()])


def draw_boxes_bev(ax, boxes_lidar, color=GT_COLOR, facecolor=None):
    """Rotated BEV rectangles (plot_gt_bev semantics: rectangle anchored at
    the rotated left-bottom corner)."""
    from matplotlib import pyplot as plt

    for box in np.asarray(boxes_lidar):
        x, y, w, h, angle = box[0], box[1], box[3], box[4], box[6]
        diag = np.hypot(w, h) / 2
        phi = np.arctan2(h, w) + angle
        ax.add_patch(plt.Rectangle(
            (x - diag * np.cos(phi), y - diag * np.sin(phi)), w, h,
            angle=np.degrees(angle), fill=facecolor is not None,
            facecolor=facecolor, edgecolor=color, linewidth=1))


def _camera_annos_to_lidar(annos, calib, class_names):
    """KITTI-style annos (location/dimensions/rotation_y in camera frame)
    -> (boxes_lidar (N, 7), names, scores?) filtered to class_names."""
    from .box_utils import boxes3d_kitti_camera_to_lidar

    names = np.asarray(annos["name"])
    # class filter only: gt annos carry score = -1.0 (kitti_base.py), so a
    # score cut here would drop every gt box; dt score thresholding is the
    # caller's job (reference scripts apply it before the conversion)
    keep = np.isin(names, list(class_names))
    if not keep.any():
        return np.zeros((0, 7), np.float32), names[:0], np.zeros(0), keep
    loc = np.asarray(annos["location"])[keep]
    dims = np.asarray(annos["dimensions"])[keep]
    rots = np.asarray(annos["rotation_y"])[keep]
    cam = np.concatenate([loc, dims, rots[:, None]], axis=1).astype(
        np.float32)
    boxes = np.asarray(boxes3d_kitti_camera_to_lidar(cam, calib))
    scores = (np.asarray(annos["score"])[keep] if "score" in annos
              else np.ones(len(boxes)))
    return boxes, names[keep], scores, keep


def load_kitti_frame(data_root, frame_id, image_ext, radar_dims,
                     image_crop_rows=None):
    """Shared per-frame loading for the renderers: normalized image,
    radar points, calibration (+ lidar->cam / cam->img matrices)."""
    from matplotlib import pyplot as plt

    from .calibration import Calibration, calib_to_matricies

    data_root = Path(data_root)
    img = np.asarray(
        plt.imread(data_root / "training/image_2"
                   / f"{frame_id}{image_ext}"), np.float32)
    if img.dtype == np.float32 and img.max() > 1.5:
        img = img / 255.0
    if image_crop_rows:
        img = img[:image_crop_rows]
    pts = np.fromfile(
        data_root / "training/velodyne" / f"{frame_id}.bin",
        np.float32).reshape(-1, radar_dims)
    calib = Calibration(data_root / "training/calib" / f"{frame_id}.txt")
    l2c, c2i = calib_to_matricies(calib)
    return img, pts, calib, l2c, c2i


def clean_gt_annos(annos):
    """Drop DontCare rows from a KITTI-style annos dict (array values)."""
    keep = np.asarray(annos["name"]) != "DontCare"
    return {k: np.asarray(v)[keep] for k, v in annos.items()
            if isinstance(v, (list, np.ndarray))}


def render_results(data_root, result_pkl, save_path, class_names,
                   image_ext=".jpg", radar_dims=7, virtual_prefix=None,
                   bev_xlim=(0, 50), bev_ylim=(-25, 25),
                   score_thresh=0.4, frame_stride=10, max_frames=None,
                   image_crop_rows=None):
    """Render gt + detection figures for every stride-th val frame:
    <id>_3d_gt.png, <id>_bev_gt.png, <id>_3d_dt.png, <id>_bev_dt.png.
    `virtual_prefix` adds the RHGM virtual-point overlay (the *_graps
    variants); None is the *_baseline behavior."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    data_root = Path(data_root)
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    infos = np.load(data_root / "kitti_infos_val.pkl", allow_pickle=True)
    with open(result_pkl, "rb") as f:
        det_result = pickle.load(f)

    idxes = list(range(0, len(infos), frame_stride))
    if max_frames:
        idxes = idxes[:max_frames]
    for idx in idxes:
        gt, dt = infos[idx], det_result[idx]
        frame_id = gt["image"]["image_idx"]
        img, pts, calib, l2c, c2i = load_kitti_frame(
            data_root, frame_id, image_ext, radar_dims, image_crop_rows)
        vp = None
        if virtual_prefix:
            d = np.load(data_root / "training" / virtual_prefix
                        / f"{frame_id}.pkl.npy", allow_pickle=True).item()
            vp = d["virtual_points"]

        ann = clean_gt_annos(gt["annos"])
        gt_boxes, gt_names, _, gt_keep = _camera_annos_to_lidar(
            ann, calib, class_names)
        # the BEV gt figures only draw boxes that contain points
        # (visual_result_vod_graps.py:255 `num_points_in_gt[mask] > 0`)
        if "num_points_in_gt" in ann:
            occupied = np.asarray(ann["num_points_in_gt"])[gt_keep] > 0
        else:
            occupied = np.ones(len(gt_boxes), bool)

        dt_ann = {k: v for k, v in dt.items() if k != "frame_id"}
        keep = np.asarray(dt_ann.get("score", [])) > score_thresh
        dt_ann = {k: np.asarray(v)[keep] for k, v in dt_ann.items()
                  if isinstance(v, (list, np.ndarray))
                  and len(np.asarray(v)) == len(keep)}
        dt_boxes, dt_names, dt_scores, _ = _camera_annos_to_lidar(
            dt_ann, calib, class_names)

        def image_fig(boxes, colors, suffix):
            fig, ax = plt.subplots(dpi=200)
            draw_boxes_image(ax, boxes, l2c, c2i, colors)
            ax.imshow(img)
            ax.axis("off")
            fig.savefig(save_path / f"{frame_id}_{suffix}.png",
                        bbox_inches="tight", pad_inches=0)
            plt.close(fig)

        def bev_fig(boxes, suffix, gt_underlay=None):
            fig, ax = plt.subplots(dpi=200)
            ax.set_xlim(*bev_xlim)
            ax.set_ylim(*bev_ylim)
            draw_points_bev(ax, pts, REAL_POINT_COLOR)
            if vp is not None and len(vp):
                draw_points_bev(ax, vp, VIRTUAL_POINT_COLOR, stroke=0.5)
            if gt_underlay is not None:
                # filled translucent gt under the dt outlines
                # (visual_result_vod_graps.py:318-320)
                draw_boxes_bev(ax, gt_underlay, color=GT_COLOR,
                               facecolor=(*GT_COLOR, 0.3))
            draw_boxes_bev(ax, boxes)
            ax.axis("off")
            fig.savefig(save_path / f"{frame_id}_{suffix}.png")
            plt.close(fig)

        # gt boxes are uniform purple (per-class colors are commented out in
        # the reference, :206-214); dt boxes are colored per class (:272-280)
        image_fig(gt_boxes, [GT_COLOR] * len(gt_boxes), "3d_gt")
        bev_fig(gt_boxes[occupied], "bev_gt")
        image_fig(dt_boxes,
                  [CLASS_COLORS.get(n, GT_COLOR) for n in dt_names], "3d_dt")
        bev_fig(dt_boxes, "bev_dt", gt_underlay=gt_boxes[occupied])
    return len(idxes)
