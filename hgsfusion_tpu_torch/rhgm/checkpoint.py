"""Mask2Former weights from files: the published detectron2 ``.pkl`` and
this package's ``.pth``.

The published swin-L Cityscapes checkpoint (``model_final_*.pkl``) is a
pickle of ``{"model": {name: ndarray}, ...}`` written under Python 2, read
with ``encoding="latin1"`` (the JAX package's
``train/torch_convert.py::load_d2_checkpoint`` reads it the same way). Its
names are ``Mask2FormerInstance``'s, so it loads with ``load_state_dict``;
the buffers the model does not hold (the criterion's ``empty_weight``,
``pixel_mean``/``pixel_std``, a classification swin's ``attn_mask``) are
dropped by name, every other key must match.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

# published buffers that the port's model does not hold
SKIPPED = ("attn_mask", "empty_weight", "pixel_mean", "pixel_std")


def load_d2_checkpoint(path) -> dict:
    """``{name: tensor}`` of a ``.pkl`` (detectron2) or ``.pth`` (this
    package's ``state_dict``, or a dict holding one under ``"model"``)."""
    p = Path(path)
    if p.suffix == ".pkl":
        with open(p, "rb") as f:
            ckpt = pickle.load(f, encoding="latin1")
        state = ckpt.get("model", ckpt)
        return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    if p.suffix in (".pth", ".pt"):
        state = torch.load(p, map_location="cpu", weights_only=True)
        return state.get("model", state)
    raise ValueError(
        f"{path}: not a .pkl or .pth file. An orbax checkpoint directory of the JAX "
        "package is converted where JAX is installed: restore its variables, pass them "
        "through hgsfusion_tpu_torch.weights.from_jax_mask2former and torch.save the "
        "result as a .pth")


def load_mask2former(model, path) -> list:
    """Load ``path`` into ``model`` strictly, apart from the SKIPPED
    buffers; returns the names dropped."""
    state = load_d2_checkpoint(path)
    dropped = sorted(k for k in state if any(s in k for s in SKIPPED))
    model.load_state_dict({k: v for k, v in state.items() if k not in dropped}, strict=True)
    return dropped
