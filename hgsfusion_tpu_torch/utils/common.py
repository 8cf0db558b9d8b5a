"""Shared geometry helpers (counterpart of ``hgsfusion_tpu/utils/common.py``)."""
from __future__ import annotations

import functools
import math

import torch


@functools.cache
def _constant(values, dtype, device):
    with torch.inference_mode(False):  # usable by autograd after a served frame
        return torch.tensor(values, dtype=dtype).to(device)


def device_constant(values, dtype, device) -> torch.Tensor:
    """A small constant tensor (nested tuples of numbers) on ``device``,
    copied there once per process: a copy from pageable host memory inside a
    step would make the host wait for the device. Read-only."""
    return _constant(values, dtype, torch.device(device))


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap angles into [-offset*period, (1-offset)*period):
    val - floor(val / period + offset) * period."""
    return val - torch.floor(val / period + offset) * period
