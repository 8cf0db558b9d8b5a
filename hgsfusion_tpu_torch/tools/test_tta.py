"""Test-time-augmentation evaluation CLI (counterpart of the JAX package's
``tools/test_tta.py``).

    python -m hgsfusion_tpu_torch.tools.test_tta --cfg_file configs/hgsfusion_vod.yaml \\
        [--ckpt model.pth | --ckpt_dir <out>/ckpt [--ckpt_step N]] [--tta_num 4] \\
        [--device cuda] [--max_frames N] [--set DATA_CONFIG.DATA_PATH <root> ...]

Each val frame (B=1) is served ``--tta_num`` times through
``HGSFusionModel.serve``, once per augmented copy (``eval/tta.py``, frame i
with ``seed=i``), and each copy's detections are scored against that copy's
augmented gt, with no inverse ensembling: the official VoD or TJ4D
evaluation over ``tta_num`` x frames, and ``result.pkl`` under
``<output_dir>/<TAG>/<extra_tag>/eval_tta``.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from ..config import cfg_from_list, load_config, model_config_from_yaml
from ..datasets import build_dataset
from ..datasets.tj4d import TJ4DDataset
from ..eval.tj4d_eval import tj4d_official_eval
from ..eval.tta import make_tta_variants
from ..eval.vod_eval import vod_official_eval
from ..models.detector import resolve_device
from ..models.registry import build_network
from ..ops import library
from ..train.checkpoint import CheckpointManager, load_checkpoint
from ..train.trainer import detections_to_pred_dicts
from ..utils import box_utils
from ..utils.common import create_logger


def frame_variants(dataset, i: int, tta_num: int):
    """Frame ``i``'s padded sample with its gt (eval mode keeps it) and its
    ``tta_num`` augmented copies, and the frame's calibration."""
    input_dict = dataset.compose_input_dict(i)
    data_dict = (dataset.prepare_data(input_dict)
                 or dataset.prepare_data(dataset.compose_input_dict(i)))
    sample = dataset.pad_to_static(data_dict)
    calib = input_dict["calib"]
    return make_tta_variants(sample, calib, tta_num, seed=i), calib


def augmented_gt_anno(batch, calib, class_names) -> dict:
    """A variant's augmented gt as the KITTI annotation it is scored
    against (the reference's eval_one_epoch_tta)."""
    gt = np.asarray(batch["gt_boxes"][0])
    gt = gt[gt[:, -1] > 0]
    cam = box_utils.boxes3d_lidar_to_kitti_camera(gt[:, :7], calib)
    bbox = box_utils.boxes3d_kitti_camera_to_imageboxes(
        cam, calib, image_shape=np.asarray(batch["image_shape"][0]).reshape(-1))
    names = np.array([class_names[int(c) - 1] for c in gt[:, -1]])
    return {"name": names, "location": cam[:, 0:3], "dimensions": cam[:, 3:6],
            "rotation_y": cam[:, 6], "bbox": bbox, "alpha": np.zeros(len(gt)),
            "occluded": np.zeros(len(gt)), "truncated": np.zeros(len(gt)),
            "difficulty": np.zeros(len(gt), np.int32)}


def run_tta(model, dataset, logger, tta_num: int = 4, max_frames=None):
    """Every variant of every frame through ``model.serve``, then the
    dataset's official evaluation against the augmented gts. Returns
    (det_annos, gt_annos, result_dict, launches): one anno per variant in
    frame order, and the kernel launches of each variant."""
    det_annos, gt_annos, launches = [], [], []
    n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
    for i in range(n):
        variants, calib = frame_variants(dataset, i, tta_num)
        for variant in variants:
            batch = dataset.collate_batch([variant])
            before = dict(library.launches)
            out = model.serve(batch)
            launches.append({k: library.launches[k] - before[k] for k in before})
            det_annos += dataset.generate_prediction_dicts(
                batch, detections_to_pred_dicts(out), dataset.class_names)
            gt_annos.append(augmented_gt_anno(batch, calib, dataset.class_names))
        if i % 20 == 0:
            logger.info(f"tta eval {i}/{n}")
    # the dataset's own protocol over the augmented gts: TJ4D must not be
    # scored with VoD's
    evaluate = tj4d_official_eval if isinstance(dataset, TJ4DDataset) else vod_official_eval
    result_str, result_dict = evaluate(gt_annos, det_annos, dataset.class_names)
    logger.info("\n" + result_str)
    return det_annos, gt_annos, result_dict, launches


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--ckpt", default=None, help="a .pth file (as tools/test.py takes it)")
    p.add_argument("--ckpt_dir", default=None, help="a checkpoint directory of tools/train.py")
    p.add_argument("--ckpt_step", type=int, default=None)
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--tta_num", type=int, default=4)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed without a ckpt")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    """Returns (det_annos, gt_annos, result_dict, launches) of ``run_tta``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    out_dir = Path(args.output_dir) / cfg["TAG"] / args.extra_tag / "eval_tta"
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(out_dir / "eval_tta.log")
    dataset = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False,
                            logger=logger)
    model = build_network(cfg, model_config_from_yaml(cfg), device=device, seed=args.seed)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, log=logger)
        step = args.ckpt_step if args.ckpt_step is not None else mgr.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint in {args.ckpt_dir}")
        load_checkpoint(model, mgr.path(step), logger)
        logger.info(f"loaded checkpoint step {step}")
    elif args.ckpt:
        load_checkpoint(model, args.ckpt, logger)
        logger.info(f"loaded {args.ckpt}")
    else:
        logger.warning(f"no checkpoint: evaluating random weights from seed {args.seed}")
    out = run_tta(model, dataset, logger, args.tta_num, args.max_frames)
    with open(out_dir / "result.pkl", "wb") as f:
        pickle.dump(out[0], f)
    logger.info(f"results saved to {out_dir}")
    return out


if __name__ == "__main__":
    main()
