"""Demo: run a detector on a dataset's frames and draw what it finds
(counterpart of the JAX package's ``tools/demo.py``).

    python -m hgsfusion_tpu_torch.tools.demo --cfg_file configs/radar_pillar_vod.yaml \\
        [--ckpt model.pth | --ckpt_dir <out>/ckpt] [--frames 4] [--out_dir demo_out] \\
        [--html] [--device cuda] [--set DATA_CONFIG.DATA_PATH <root> ...]

Any family ``models/registry.py::build_network`` builds (HGSFusion, the
radar-only detector, the PointPillar families, BEVFusion, TransFusion-L,
CenterPoint, SECOND, VoxelNeXt),
served one frame at a time
through ``serve`` on the card (``--device cpu`` on the CPU). Per frame it
writes ``<frame>_bev.png`` (the points, the gt boxes in cyan, the
detections in lime with their scores), ``<frame>_img.png`` where the frame
carries a camera image (the boxes projected into it) and, with ``--html``,
``<frame>_3d.html``, a self-contained 3-D viewer (``utils/visual_3d.py``).
The PNGs need matplotlib, imported here at the call: without it the demo
says so, writes no PNG and still serves every frame and writes the HTML.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..config import cfg_from_list, load_config, model_config_from_yaml
from ..datasets import build_dataset
from ..models.detector import resolve_device
from ..models.registry import build_network
from ..ops import library
from ..train.checkpoint import CheckpointManager, load_checkpoint
from ..train.trainer import detections_to_pred_dicts
from ..utils.common import create_logger
from ..utils.visual import draw_bev, draw_image_boxes
from ..utils.visual_3d import export_html


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--ckpt", default=None, help="a .pth file of tools/train.py or a state_dict")
    p.add_argument("--ckpt_dir", default=None, help="a checkpoint directory (its newest step)")
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed without a ckpt")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--out_dir", default="demo_out")
    p.add_argument("--html", action="store_true", help="also write a 3-D HTML viewer per frame")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def main(argv=None) -> dict:
    """Returns the frames served, the files written and the kernel launches."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    model_cfg = model_config_from_yaml(cfg)
    logger = create_logger()
    dataset = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False,
                            logger=logger)
    model = build_network(cfg, model_cfg, device=device, seed=args.seed)
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, log=logger)
        step = ckpt.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint in {args.ckpt_dir}")
        load_checkpoint(model, ckpt.path(step), logger)
    elif args.ckpt:
        load_checkpoint(model, args.ckpt, logger)
    else:
        logger.warning(f"no checkpoint: random weights from seed {args.seed}")
    plt = _pyplot()
    if plt is None:
        logger.warning("matplotlib is not installed: no PNG is written")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng4 = (model_cfg.pc_range[0], model_cfg.pc_range[1],
            model_cfg.pc_range[3], model_cfg.pc_range[4])
    launches0 = dict(library.launches)
    written = {"png": [], "html": []}
    frames = min(args.frames, len(dataset))
    for i in range(frames):
        batch = dataset.collate_batch([dataset[i]])
        pred = detections_to_pred_dicts(model.serve(batch))[0]
        frame = str(batch["frame_id"][0])
        pts = np.asarray(batch["points"][0])[np.asarray(batch["points_valid"][0])]
        gt = np.asarray(batch["gt_boxes"][0])
        gt = gt[gt[:, -1] > 0][:, :7]
        boxes, scores = pred["pred_boxes"][:, :7], pred["pred_scores"]
        if plt is not None:
            fig, ax = plt.subplots(figsize=(8, 8), dpi=150)
            draw_bev(ax, pts, gt, color="cyan", pc_range=rng4)
            draw_bev(ax, pts[:0], boxes, scores=scores, color="lime", pc_range=rng4)
            ax.set_title(f"frame {frame}: gt cyan, pred lime", color="black")
            fig.savefig(out_dir / f"{frame}_bev.png", facecolor="gray")
            plt.close(fig)
            written["png"].append(str(out_dir / f"{frame}_bev.png"))
            if "images" in batch and batch.get("calib") is not None:
                image = np.asarray(batch["images"][0])
                if image.dtype == np.uint8:
                    image = image.astype(np.float32) / 255.0
                fig, ax = plt.subplots(figsize=(10, 4), dpi=150)
                draw_image_boxes(ax, image, gt, batch["calib"][0], color="cyan")
                draw_image_boxes(ax, image, boxes, batch["calib"][0], color="lime",
                                 scores=scores, show_image=False)
                fig.savefig(out_dir / f"{frame}_img.png")
                plt.close(fig)
                written["png"].append(str(out_dir / f"{frame}_img.png"))
        if args.html:
            path = export_html(out_dir / f"{frame}_3d.html", pts, gt_boxes=gt, pred_boxes=boxes,
                               pred_scores=scores,
                               title=f"frame {frame} — gt cyan, pred green")
            written["html"].append(str(path))
        logger.info(f"frame {frame}: {len(boxes)} detections")
    launches = {k: library.launches[k] - launches0[k] for k in launches0}
    logger.info(f"wrote {len(written['png'])} PNG and {len(written['html'])} HTML files to "
                f"{out_dir}" + ("" if plt is not None else " (no matplotlib: no PNG)"))
    logger.info(f"kernel launches: {json.dumps(launches)}")
    return {"frames": frames, "matplotlib": plt is not None, **written, "launches": launches}


if __name__ == "__main__":
    main()
