"""Offline RHGM: generate hybrid (virtual + foreground real) radar points
(counterpart of the JAX package's ``tools/generate_hybrid_points.py``).

    python -m hgsfusion_tpu_torch.tools.generate_hybrid_points --dataset vod \\
        --data_root data/vod --pts_save_path data/vod/training/<prefix> \\
        [--mask_source model|precomputed|gtbox] [--ckpt model_final.pkl] \\
        [--resize_shortest 1024] [--device cuda] ...

For every frame of a KITTI-style tree: instance masks, the radar points
projected into the image, the RHGM sampling (``rhgm/generator.py``, numpy
on the host) and ``<pts_save_path>/<frame_id>.pkl.npy``, a dict of
``virtual_points`` and ``real_points``, the files the datasets read under
their ``VIRTUAL_POINT_PREFIX``.

Mask sources (``--mask_source``):
  model        ``rhgm.mask2former.Mask2FormerInstance`` on ``--device``
               (default cuda, no CPU fallback), weights from ``--ckpt``: the
               published detectron2 ``.pkl`` (swin-L Cityscapes
               ``model_final_*.pkl``) or this package's ``.pth``
               ``state_dict``; random weights from ``--seed`` without one
               (masks meaningless: pipeline checks only). An orbax directory
               of the JAX package is refused: ``weights.from_jax_mask2former``
               converts it where JAX is installed.
  precomputed  ``<masks_dir>/<frame_id>.npz`` with ``masks`` (M, H, W),
               ``labels`` (M,) cityscapes-things ids, optional ``scores``.
  gtbox        the 2D gt boxes of ``label_2`` rasterized into masks.

The files equal the JAX tool's for the same arguments and ``--seed``.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..datasets.image_io import read_image
from ..models.layers import resize_bilinear
from ..rhgm.checkpoint import load_mask2former
from ..rhgm.generator import generate_hybrid_points, masks_from_gt_boxes2d
from ..rhgm.mask2former import Mask2FormerInstance, instance_inference
from ..utils.calibration import get_calib_from_file

# cityscapes-things bin of each annotation class the gtbox source reads
_ANNOT_TO_THING = {
    "Pedestrian": 0, "person": 0, "Cyclist": 1, "rider": 1, "Car": 2,
    "car": 2, "Van": 2, "Truck": 3, "truck": 3, "Bus": 4, "bus": 4,
    "Tram": 5, "train": 5, "Motorcycle": 6, "motorcycle": 6,
    "bicycle": 7, "Bicycle": 7,
}

_DATASETS = {
    # image rows used, image ext, radar feature columns after xyz
    "vod": dict(image_hw=(516, 1936), ext=".jpg", radar_dims=7),
    "tj4d": dict(image_hw=(810, 1280), ext=".png", radar_dims=8),
}

# the model presets: swin-L (the reference's scale) and a tiny variant for
# smoke tests
PRESETS = {
    "large": {},
    "tiny": dict(embed_dims=32, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4,
                 hidden_dim=64, num_queries=20, dec_layers=3, dim_feedforward=128,
                 pd_enc_layers=2, pd_ffn=256),
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", choices=sorted(_DATASETS), default="vod")
    p.add_argument("--data_root", required=True,
                   help="KITTI-style root: training/{velodyne,calib,...}")
    p.add_argument("--split", default="train",
                   help="ImageSets/<split>.txt frame list; falls back to every velodyne file")
    p.add_argument("--pts_save_path", required=True)
    p.add_argument("--mask_source", default="model", choices=("model", "precomputed", "gtbox"))
    p.add_argument("--masks_dir", default=None,
                   help="precomputed: directory of <frame_id>.npz files")
    p.add_argument("--ckpt", default=None,
                   help="model: the published detectron2 .pkl or this package's .pth; "
                        "random weights from --seed when omitted")
    p.add_argument("--resize_shortest", type=int, default=0,
                   help="model: resize the shortest image edge to this before segmentation, "
                        "as the reference predictor does (MIN_SIZE_TEST=1024 in the "
                        "cityscapes config); masks come back at the original size. 0 = off")
    p.add_argument("--confidence_threshold", type=float, default=0.5,
                   help="model: min instance score")
    p.add_argument("--num_virtual", type=int, default=100)
    p.add_argument("--dist_thresh", type=float, default=3000.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--model_preset", default="large", choices=sorted(PRESETS),
                   help="model: swin-L (reference scale) or a tiny variant for smoke tests")
    p.add_argument("--pixel_decoder", default="msdeform", choices=("msdeform", "fpn"),
                   help="model: msdeform matches the published checkpoints; fpn is the "
                        "gather-free variant")
    p.add_argument("--image_hw", type=int, nargs=2, default=None,
                   help="override the dataset's image size (synthetic or re-cropped trees)")
    p.add_argument("--device", default="cuda", help="model: the segmentor's device")
    return p.parse_args(argv)


def frame_ids(root: Path, split: str):
    f = root / "ImageSets" / f"{split}.txt"
    if f.exists():
        return [ln.strip() for ln in f.read_text().splitlines() if ln.strip()]
    return sorted(p.stem for p in (root / "training/velodyne").glob("*.bin"))


def load_calib(root: Path, idx: str):
    """lidar->cam 4x4 and the 3x3 intrinsics in a 3x4, the matrices the
    reference generator takes (Tr_velo_to_cam and P2[:3, :3]: no R0
    rectification, no P2 translation column)."""
    c = get_calib_from_file(root / "training/calib" / f"{idx}.txt")
    v2c = np.vstack([c["Tr_velo2cam"], [0.0, 0.0, 0.0, 1.0]]).astype(np.float32)
    k = np.zeros((3, 4), np.float32)
    k[:3, :3] = c["P2"][:3, :3]
    return v2c, k


def load_gt_masks(root: Path, idx: str, image_hw):
    boxes, classes = [], []
    f = root / "training/label_2" / f"{idx}.txt"
    if f.exists():
        for ln in f.read_text().splitlines():
            t = ln.split()
            if len(t) < 8 or t[0] not in _ANNOT_TO_THING:
                continue
            boxes.append([float(x) for x in t[4:8]])
            classes.append(_ANNOT_TO_THING[t[0]])
    if not boxes:
        return np.zeros((0,) + tuple(image_hw), bool), np.zeros(0, np.int64)
    return masks_from_gt_boxes2d(np.asarray(boxes, np.float32), np.asarray(classes), image_hw)


def load_precomputed_masks(masks_dir: Path, idx: str, image_hw, thresh):
    f = masks_dir / f"{idx}.npz"
    if not f.exists():
        return np.zeros((0,) + tuple(image_hw), bool), np.zeros(0, np.int64)
    d = np.load(f)
    masks = d["masks"].astype(bool)
    labels = d["labels"].astype(np.int64)
    if "scores" in d:
        keep = d["scores"] >= thresh
        masks, labels = masks[keep], labels[keep]
    keep = masks.any(axis=(1, 2))  # the reference's postprocess drops empty masks
    return masks[keep], labels[keep]


def read_rgb01(path) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]."""
    img = read_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.asarray(img, np.float32) / 255.0


class ModelMaskSource:
    """Mask2FormerInstance + instance_inference at a fixed image size.

    With resize_shortest > 0 the image is resized bilinearly so that its
    shortest edge has that length before segmentation (the reference
    predictor's ResizeShortestEdge); the mask logits are resized straight
    to the original size. ``segment`` returns the kept instances on the
    device; ``__call__`` the host copies the generator takes."""

    def __init__(self, preset: str, ckpt, image_hw, thresh, resize_shortest: int = 0,
                 pixel_decoder: str = "msdeform", device="cuda", seed: int = 0):
        self.model = Mask2FormerInstance(pixel_decoder=pixel_decoder, device=device, seed=seed,
                                         **PRESETS[preset])
        if ckpt:
            dropped = load_mask2former(self.model, ckpt)
            print(f"[generate_hybrid_points] loaded {ckpt}"
                  + (f" (dropped {len(dropped)} buffers)" if dropped else ""))
        else:
            print("[generate_hybrid_points] WARNING: --ckpt not given; running a RANDOMLY "
                  "INITIALIZED segmentor (pipeline validation only, masks are meaningless)")
        self.image_hw = tuple(image_hw)
        if resize_shortest and resize_shortest > 0:
            s = resize_shortest / min(self.image_hw)
            self.model_hw = (int(round(self.image_hw[0] * s)), int(round(self.image_hw[1] * s)))
        else:
            self.model_hw = self.image_hw
        self.thresh = float(thresh)
        dev = self.model.device
        self.mean = torch.tensor(IMAGENET_MEAN, device=dev)
        self.std = torch.tensor(IMAGENET_STD, device=dev)

    @torch.inference_mode()
    def segment(self, image: np.ndarray):
        """(H, W, 3) [0, 1] image, cropped or zero-padded to image_hw ->
        (masks (M, H, W) bool, labels (M,)) of the instances scoring at
        least the threshold, on the device."""
        h, w = self.image_hw
        img = np.zeros((1, h, w, 3), np.float32)
        ih, iw = min(h, image.shape[0]), min(w, image.shape[1])
        img[0, :ih, :iw] = image[:ih, :iw]
        x = torch.from_numpy(img).to(self.model.device)
        x = resize_bilinear(x, self.model_hw)
        out = self.model((x - self.mean) / self.std)
        labels, scores, masks = instance_inference(out["pred_logits"], out["pred_masks"],
                                                   self.image_hw)
        keep = torch.nonzero(scores >= self.thresh)[:, 0]
        return masks[keep], labels[keep]

    def __call__(self, image: np.ndarray):
        """The kept instances as host arrays (one copy of the masks); sets
        ``timing``: the segmentation's ms up to a device synchronize and the
        copy's ms."""
        t0 = time.perf_counter()
        masks, labels = self.segment(image)
        if masks.is_cuda:
            torch.cuda.synchronize(masks.device)
        t1 = time.perf_counter()
        out = masks.cpu().numpy(), labels.cpu().numpy().astype(np.int64)
        self.timing = {"segment_ms": (t1 - t0) * 1e3,
                       "copy_ms": (time.perf_counter() - t1) * 1e3}
        return out


def main(argv=None) -> dict:
    """Run the tool; returns what it did: per frame the masks, the points,
    the host ms of the mask source (for the model, after the image is read:
    ``segment_ms`` up to a device synchronize, ``copy_ms``) and of the
    generator with the file write, and of the whole frame; the frames per
    second of the loop."""
    args = parse_args(argv)
    spec = dict(_DATASETS[args.dataset])
    if args.image_hw:
        spec["image_hw"] = tuple(args.image_hw)
    root = Path(args.data_root)
    out_dir = Path(args.pts_save_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    ids = frame_ids(root, args.split)
    if args.max_frames:
        ids = ids[: args.max_frames]
    if not ids:
        raise SystemExit(f"no frames found under {root}")

    model_src = None
    if args.mask_source == "model":
        model_src = ModelMaskSource(
            args.model_preset, args.ckpt, spec["image_hw"], args.confidence_threshold,
            resize_shortest=args.resize_shortest, pixel_decoder=args.pixel_decoder,
            device=args.device, seed=args.seed)
    elif args.mask_source == "precomputed" and not args.masks_dir:
        raise SystemExit("--mask_source precomputed needs --masks_dir")

    rng = np.random.RandomState(args.seed)
    frames = []
    t_start = time.perf_counter()
    for i, idx in enumerate(ids):
        t_frame = time.perf_counter()
        raw = np.fromfile(root / "training/velodyne" / f"{idx}.bin",
                          np.float32).reshape(-1, spec["radar_dims"])
        v2c, k = load_calib(root, idx)
        t0 = time.perf_counter()
        if args.mask_source == "gtbox":
            masks, labels = load_gt_masks(root, idx, spec["image_hw"])
        elif args.mask_source == "precomputed":
            masks, labels = load_precomputed_masks(Path(args.masks_dir), idx, spec["image_hw"],
                                                   args.confidence_threshold)
        else:
            image = read_rgb01(root / "training/image_2" / f"{idx}{spec['ext']}")
            # TJ4D keeps the top 810 rows of its images
            image = image[: spec["image_hw"][0]]
            t0 = time.perf_counter()
            masks, labels = model_src(image)
        t1 = time.perf_counter()
        res = generate_hybrid_points(masks, labels, raw, v2c, k, num_virtual=args.num_virtual,
                                     dist_thresh=args.dist_thresh, rng=rng)
        np.save(out_dir / f"{idx}.pkl", res)  # np.save appends .npy
        t2 = time.perf_counter()
        frames.append({"id": idx, "masks": len(masks), "mask_ms": (t1 - t0) * 1e3,
                       "generate_ms": (t2 - t1) * 1e3, "frame_ms": (t2 - t_frame) * 1e3,
                       "virtual": len(res["virtual_points"]), "real": len(res["real_points"]),
                       **(model_src.timing if model_src else {})})
        if (i + 1) % 50 == 0 or i + 1 == len(ids):
            print(f"[{i + 1}/{len(ids)}] {idx}: {frames[-1]['virtual']} virtual / "
                  f"{frames[-1]['real']} fg-real points")
    wall_s = time.perf_counter() - t_start
    n_virtual = sum(f["virtual"] for f in frames)
    print(f"done: {len(ids)} frames -> {out_dir} ({n_virtual} virtual points total)")
    return {"frames": frames, "virtual_total": n_virtual, "wall_s": wall_s,
            "frames_per_s": len(ids) / wall_s}


if __name__ == "__main__":
    main()
