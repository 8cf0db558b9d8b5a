"""Write the structured synthetic trees of the detection-level study
(counterpart of the JAX package's ``tools/make_study_data.py``).

    python -m hgsfusion_tpu_torch.tools.make_study_data --root <R> [--datasets vod tj4d] \\
        [--num_frames 96] [--val_frames 32] [--hard_val]

Flagship-size LEARNABLE scenes (``datasets/synthetic.py``, ``structured=True``:
radar and virtual points clustered in the gt boxes with class-signature
features, class-coloured image blobs) with DISJOINT train and val splits,
then the info files through this package's ``tools/create_infos.py``. A
detector trained on the train split makes held-out detections with meaning,
which white-noise trees cannot give (AP pins near 0 there).

Writes ``<R>/vod`` and ``<R>/tj4d`` (``--hard_val``: ``<R>/<name>_hardval``);
the configs read them with ``--set DATA_CONFIG.DATA_PATH <R>/vod``, since
the virtual points go under the shipped configs' ``VIRTUAL_POINT_PREFIX``.
The same arguments write the JAX tool's trees (the PNG images' bytes aside:
this package writes PNG itself, with the same pixels).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..config import cfg_from_list, load_config
from ..datasets.synthetic import make_synthetic_kitti
from .create_infos import create_infos

REPO = Path(__file__).resolve().parents[2]
# the shipped configs' RHGM prefix (hgsfusion_vod.yaml DATA_CONFIG)
PREFIX = "mask_maskformer_with_label_k_1_gauss_k_4_uniform"

SPECS = {
    # flagship VoD: 516x1936 frames (vod_fusion.yaml IMAGE_SIZE), 7-ch
    # radar, 3 classes; 4096 radar + 2048 virtual points a frame stay under
    # the MAX_POINTS=16384 static pad after the hybrid merge
    "vod": dict(
        num_points=4096, num_virtual=2048, num_boxes=6,
        image_hw=(516, 1936), radar_channels=7, image_ext=".jpg",
        classes=("Car", "Pedestrian", "Cyclist"), seed=50,
        cfg="configs/hgsfusion_vod.yaml",
    ),
    # flagship TJ4D: 810x1280 png frames (tj4d_fusion.yaml IMAGE_SIZE),
    # 8-ch 4D radar, 4 classes incl. Truck
    "tj4d": dict(
        num_points=4096, num_virtual=2048, num_boxes=6,
        image_hw=(810, 1280), radar_channels=8, image_ext=".png",
        classes=("Car", "Pedestrian", "Cyclist", "Truck"), seed=51,
        cfg="configs/hgsfusion_tj4d.yaml",
    ),
}


def build(name: str, root: Path, num_frames: int, val_frames: int,
          hard_val: bool = False) -> Path:
    """One tree. hard_val=True builds an EVAL-ONLY variant
    (``<root>/<name>_hardval``): every frame in val.txt, each box's point
    support log-uniform in [0.02, 1.0], so that a trained model's recall
    sits inside the PR curve for every class. On the uniformly easy default
    scenes the model reaches recall 1.0, where the 11-point AP quantizes
    deltas to 0 or 9.09 points; the support gradient resolves AP deltas
    below 0.5."""
    spec = dict(SPECS[name])
    cfg_path = spec.pop("cfg")
    out = Path(root) / (f"{name}_hardval" if hard_val else name)
    if hard_val:
        spec["seed"] += 100
        make_synthetic_kitti(out, num_frames=num_frames, structured=True,
                             virtual_prefix=PREFIX, support_range=(0.02, 1.0), **spec)
        # all frames are val; train.txt stays as written (never trained on)
    else:
        make_synthetic_kitti(out, num_frames=num_frames, structured=True,
                             virtual_prefix=PREFIX, **spec)
        # disjoint splits (the generator writes identical train/val lists)
        ids = [f"{i:05d}" for i in range(num_frames)]
        n_train = num_frames - val_frames
        (out / "ImageSets" / "train.txt").write_text("\n".join(ids[:n_train]) + "\n")
        (out / "ImageSets" / "val.txt").write_text("\n".join(ids[n_train:]) + "\n")

    # the info files, as tools/create_infos.py writes them for this config
    cfg = load_config(REPO / cfg_path)
    cfg_from_list(cfg, ["DATA_CONFIG.DATA_PATH", str(out)])
    create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True)
    p.add_argument("--datasets", nargs="+", default=["vod", "tj4d"], choices=list(SPECS))
    p.add_argument("--num_frames", type=int, default=96)
    p.add_argument("--val_frames", type=int, default=32)
    p.add_argument("--hard_val", action="store_true",
                   help="build the eval-only graded-difficulty variant "
                        "(<root>/<name>_hardval) instead")
    args = p.parse_args(argv)
    outs = {}
    for name in args.datasets:
        outs[name] = build(name, Path(args.root), args.num_frames, args.val_frames,
                           hard_val=args.hard_val)
        print(f"{name}: {outs[name]}")
    return outs


if __name__ == "__main__":
    main()
