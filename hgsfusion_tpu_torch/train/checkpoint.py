"""Checkpoints: ``.pth`` files with max-keep pruning and auto-resume
(counterpart of ``hgsfusion_tpu/train/checkpoint.py``, which writes Orbax
directories), and ``load_checkpoint`` for a model's weights.

The reference writes torch pickles (tools/train_utils/train_utils.py) and
resumes from the newest one that loads (tools/train.py); so does this
module. One file per step, ``<ckpt_dir>/checkpoint_step_<n>.pth``, holding
``{"model_state", "optimizer_state", "step"}`` with every tensor on the CPU.
The ``model_state`` key is the reference checkpoint's, so
``load_checkpoint`` reads these files as it reads a pcdet checkpoint.
"""
from __future__ import annotations

import logging
import os
import pickle
import re
import time
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger(__name__)

_NAME = re.compile(r"checkpoint_step_(\d+)\.pth$")

# a reference pcdet checkpoint's CamelCase FusionVFE names -> this package's
# (the JAX package's train/torch_convert.py::_KEY_ALIASES)
KEY_ALIASES = (
    ("fusion_vfe.ImageVFE.", "fusion_vfe.image_vfe."),
    ("fusion_vfe.RadarVFE.", "fusion_vfe.radar_backbone."),
    ("fusion_vfe.RadarOccupancy.", "fusion_vfe.radar_occupancy."),
)


def load_checkpoint(model, path, log=None) -> list:
    """Load a ``.pth`` file into ``model`` and return the keys it left out.

    Either this package's ``state_dict``, loaded strictly, or a dict with a
    ``"model_state"`` (a reference pcdet checkpoint, or this module's
    files), whose keys are normalized by KEY_ALIASES (a module registered
    under two names keeps its first). Every key of ``model`` must be there;
    keys outside the model (a pcdet checkpoint carries the unused DeepLab
    classifier, for one) are logged and returned as ``unmatched``, as the
    JAX package's converter reports them.
    """
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state" not in state:
        model.load_state_dict(state, strict=True)
        return []
    normalized = {}
    for k, v in state["model_state"].items():
        for src, dst in KEY_ALIASES:
            if k.startswith(src):
                k = dst + k[len(src):]
                break
        normalized.setdefault(k, v)
    own = model.state_dict().keys()
    unmatched = sorted(k for k in normalized if k not in own)
    model.load_state_dict({k: v for k, v in normalized.items() if k in own}, strict=True)
    if unmatched:
        (log or logger).warning(f"{path}: {len(unmatched)} unmatched keys not loaded: "
                                f"{unmatched}")
    return unmatched


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


class CheckpointManager:
    """``checkpoint_step_<n>.pth`` files under ``ckpt_dir``, at most
    ``max_to_keep`` of them."""

    def __init__(self, ckpt_dir, max_to_keep: int = 30, log=None):
        self.ckpt_dir = Path(ckpt_dir).absolute()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.log = log or logger

    def path(self, step: int) -> Path:
        return self.ckpt_dir / f"checkpoint_step_{step}.pth"

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for p in self.ckpt_dir.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> Optional[dict]:
        """Write ``{**state, "step": step}`` (tensors copied to the CPU) to a
        temporary name, then move it into place, and prune the oldest files.
        A step already saved keeps its file. Returns the step, the file's
        bytes and the seconds the save took, or None when skipped."""
        path = self.path(step)
        if path.exists():
            self.log.info(f"checkpoint step {step} already exists in {self.ckpt_dir}: "
                          "skipping the save (the existing file is kept)")
            return None
        t0 = time.perf_counter()
        tmp = path.with_name(path.name + ".tmp")
        torch.save({**_to_cpu(state), "step": step}, tmp)
        os.replace(tmp, path)
        seconds = time.perf_counter() - t0
        for old in self.all_steps()[:-self.max_to_keep]:
            self.path(old).unlink()
        return {"step": step, "bytes": path.stat().st_size, "seconds": seconds}

    def restore(self, step: Optional[int] = None):
        """``(state, step)`` from the file of ``step``, or when ``step`` is
        None from the newest file that loads (a truncated newer one is
        skipped with a warning); ``(None, None)`` when there is none."""
        if step is not None:
            return torch.load(self.path(step), map_location="cpu", weights_only=True), step
        for s in reversed(self.all_steps()):
            try:
                return torch.load(self.path(s), map_location="cpu", weights_only=True), s
            except (RuntimeError, EOFError, pickle.UnpicklingError) as exc:
                # a file cut short by a crash: try an older one
                self.log.warning(f"checkpoint {self.path(s)} does not load ({exc!r}); "
                                 "trying an older one")
        return None, None
