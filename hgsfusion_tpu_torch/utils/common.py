"""Shared geometry helpers and the logger (counterpart of
``hgsfusion_tpu/utils/common.py``)."""
from __future__ import annotations

import functools
import logging
import math
import sys

import torch


@functools.cache
def _constant(values, dtype, device):
    with torch.inference_mode(False):  # usable by autograd after a served frame
        return torch.tensor(values, dtype=dtype).to(device)


def device_constant(values, dtype, device) -> torch.Tensor:
    """A small constant tensor (nested tuples of numbers) on ``device``,
    copied there once per process: a copy from pageable host memory inside a
    step would make the host wait for the device. Read-only. While
    ``torch.export`` traces, it is made anew and not cached (a tensor made
    then is the tracer's, not a real one)."""
    if torch.compiler.is_exporting():
        return torch.tensor(values, dtype=dtype).to(device)
    return _constant(values, dtype, torch.device(device))


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap angles into [-offset*period, (1-offset)*period):
    val - floor(val / period + offset) * period."""
    return val - torch.floor(val / period + offset) * period


def create_logger(log_file=None, rank: int = 0, level=logging.INFO):
    """Console (and, given ``log_file``, file) logger; a process of rank > 0
    logs warnings only."""
    logger = logging.getLogger("hgsfusion_tpu_torch")
    logger.setLevel(level if rank == 0 else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_file is not None and rank == 0:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
