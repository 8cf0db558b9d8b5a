"""Write a dataset's info files (counterpart of the KITTI-family branch of
the JAX package's ``tools/create_infos.py``).

    python -m hgsfusion_tpu_torch.tools.create_infos --cfg_file configs/hgsfusion_vod.yaml \\
        [--splits train val] [--set DATA_CONFIG.DATA_PATH <root> ...]

The View-of-Delft and TJ4DRadSet datasets are ported; ``build_dataset``
raises for the others.
"""
from __future__ import annotations

import argparse

from ..config import cfg_from_list, load_config
from ..datasets import build_dataset
from ..utils.common import create_logger


def create_infos(data_cfg, class_names, splits=("train", "val"), logger=None):
    """kitti_infos_<split>.pkl under DATA_PATH for each split; returns their
    paths."""
    ds = build_dataset(data_cfg, class_names, training=False, logger=logger)
    return ds.create_infos(splits=tuple(splits))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg_file", required=True,
                   help="model or dataset yaml (DATA_CONFIG or top-level)")
    p.add_argument("--splits", nargs="+", default=["train", "val"])
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)
    cfg = load_config(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    logger = create_logger()
    for f in create_infos(cfg.get("DATA_CONFIG", cfg),
                          cfg.get("CLASS_NAMES", ["Car", "Pedestrian", "Cyclist"]),
                          args.splits, logger):
        logger.info(f"wrote {f}")


if __name__ == "__main__":
    main()
