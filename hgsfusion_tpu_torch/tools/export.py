"""Export a detector, its weights baked in, as one serving artifact
(counterpart of the JAX package's ``tools/export.py``).

    python -m hgsfusion_tpu_torch.tools.export --cfg_file configs/hgsfusion_vod_pallas.yaml \\
        [--ckpt model.pth | --ckpt_dir <out>/ckpt [--ckpt_step N]] [--device cuda] \\
        --out model.pt2 [--set DATA_CONFIG.DATA_PATH <root> ...]

The served graph of a batch (forward, box decode and rotated NMS: the
kernels are the ops of ``ops/library.py``, so the graph holds them whole and
reads nothing back to the host) is traced once by ``torch.export`` on the
dataset's first frame and written by ``torch.export.save``. The artifact
pins that frame's input shapes and dtypes (the same static-shape contract as
the JAX artifact) and the device it was exported on, and records them in
``inputs.json`` beside the graph. ``tools/serve.py`` runs it with no config,
no checkpoint and no model code. Without ``--ckpt`` or ``--ckpt_dir`` the
weights are random from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.nn as nn

from ..config import cfg_from_list, load_config, model_config_from_yaml
from ..datasets import build_dataset
from ..models.detector import BATCH_KEYS, TARGET_KEYS, Detector, resolve_device
from ..models.registry import build_network
from ..train.checkpoint import CheckpointManager, load_checkpoint
from ..utils.common import create_logger

# the batch keys the served graph reads (the rest are labels)
INPUT_KEYS = tuple(k for k in BATCH_KEYS if k not in TARGET_KEYS)
# the artifact's record of its inputs, beside the graph
SPEC_FILE = "inputs.json"


class ServingModule(nn.Module):
    """A batch of frames -> fixed-shape detections (``Detector.serve``
    for a batch already on the model's device)."""

    def __init__(self, model: Detector):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.post_process(self.model(batch))


def model_inputs(model: Detector, batch) -> dict:
    """The keys of ``batch`` the served graph reads, as tensors on the
    model's device."""
    return {k: v for k, v in model.batch_to_device(batch).items() if k in INPUT_KEYS}


def export_model(model: Detector, example_batch):
    """-> (``torch.export.ExportedProgram`` of ``ServingModule(model)`` on
    the example's shapes, its input spec)."""
    model.eval()
    inputs = model_inputs(model, example_batch)
    with torch.no_grad():
        program = torch.export.export(ServingModule(model), (inputs,))
    spec = {"device": model.device.type,
            "inputs": {k: {"shape": list(v.shape), "dtype": str(v.dtype).split(".")[-1]}
                       for k, v in inputs.items()}}
    return program, spec


def save_artifact(program, spec: dict, path) -> int:
    """Write the artifact; returns its bytes."""
    torch.export.save(program, str(path), extra_files={SPEC_FILE: json.dumps(spec)})
    return Path(path).stat().st_size


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--ckpt", default=None, help="a .pth file of tools/train.py or a state_dict")
    p.add_argument("--ckpt_dir", default=None,
                   help="a checkpoint directory of tools/train.py (its newest step)")
    p.add_argument("--ckpt_step", type=int, default=None, help="the step to read from --ckpt_dir")
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed without a ckpt")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True, help="the artifact (.pt2)")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    logger = create_logger()
    dataset = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False,
                            logger=logger)
    if len(dataset) == 0:
        raise SystemExit("dataset is empty: run tools/create_infos.py first")
    example = dataset.collate_batch([dataset[0]])
    model = build_network(cfg, model_config_from_yaml(cfg), device=device, seed=args.seed)
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, log=logger)
        step = args.ckpt_step if args.ckpt_step is not None else ckpt.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint in {args.ckpt_dir}")
        load_checkpoint(model, ckpt.path(step), logger)
        logger.info(f"loaded checkpoint step {step}")
    elif args.ckpt:
        load_checkpoint(model, args.ckpt, logger)
        logger.info(f"loaded {args.ckpt}")
    else:
        logger.warning(f"no checkpoint: exporting random weights from seed {args.seed}")
    t0 = time.perf_counter()
    program, spec = export_model(model, example)
    export_s = time.perf_counter() - t0
    size = save_artifact(program, spec, args.out)
    shapes = ", ".join(f"{k} {tuple(v['shape'])} {v['dtype']}" for k, v in spec["inputs"].items())
    logger.info(f"wrote {args.out} ({size / 1e6:.1f} MB, {spec['device']}, exported in "
                f"{export_s:.1f} s); inputs pinned: {shapes}")
    return {"out": args.out, "bytes": size, "export_s": export_s, **spec}


if __name__ == "__main__":
    main()
