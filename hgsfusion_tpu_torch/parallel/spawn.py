"""A process group of N ranks on this host, started from Python in place of
``torchrun``: the data-parallel tests run their ranks on the CPU over gloo,
and ``chip_smoke.py`` runs two ranks on one card over gloo. No entry point
imports it.
"""
from __future__ import annotations

import os
import socket
import tempfile

import torch
import torch.multiprocessing as mp

from .mesh import init_distributed, shutdown


def free_port() -> int:
    """A TCP port on this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world_size, device, backend, port, args, out_dir):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    ctx = init_distributed(device, backend)
    try:
        torch.save(fn(ctx, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown(ctx)


def spawn_ranks(fn, world_size: int, *args, device: str = "cpu", backend: str = "gloo"):
    """Run ``fn(ctx, *args)`` in ``world_size`` new processes on this host,
    each in a process group as torchrun would set it up (``ctx``: its
    ``DistContext``), every rank on ``device`` ("cuda:0": all on card 0);
    returns their results by rank. ``fn`` must be a module-level function
    and its results picklable (host tensors)."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_entry, nprocs=world_size, join=True,
                 args=(fn, world_size, device, backend, free_port(), args, out_dir))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
