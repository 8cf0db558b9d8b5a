"""A process group of N ranks on this host, started from Python in place of
``torchrun``: the data-parallel tests run their ranks on the CPU over gloo,
and ``chip_smoke.py`` runs two ranks on one card over gloo. No entry point
imports it.
"""
from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time

import torch
import torch.multiprocessing as mp

from .mesh import init_distributed, shutdown


def free_port() -> int:
    """A TCP port on this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world_size, device, backend, timeout, port, args, out_dir):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    ctx = init_distributed(device, backend, init_method="file://" + os.path.join(
        out_dir, "rendezvous"), timeout=datetime.timedelta(seconds=timeout))
    try:
        torch.save(fn(ctx, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown(ctx)


def spawn_ranks(fn, world_size: int, *args, device: str = "cpu", backend: str = "gloo",
                timeout: float = 300.0):
    """Run ``fn(ctx, *args)`` in ``world_size`` new processes on this host,
    each in a process group as torchrun would set it up (``ctx``: its
    ``DistContext``), every rank on ``device`` ("cuda:0": all on card 0);
    returns their results by rank. ``fn`` must be a module-level function
    and its results picklable (host tensors). The ranks first meet through a
    file store in their temporary directory (no port to race for); the
    environment also names a free port, as torchrun's does, for an entry
    point inside ``fn`` that leaves the group and joins a new one. Each
    collective waits at most ``timeout`` seconds, and ranks still running
    ``timeout`` seconds after the start are terminated and raise
    ``TimeoutError``."""
    with tempfile.TemporaryDirectory() as out_dir:
        procs = mp.spawn(_rank_entry, nprocs=world_size, join=False,
                         args=(fn, world_size, device, backend, timeout, free_port(), args,
                               out_dir))
        deadline = time.monotonic() + timeout
        while not procs.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in procs.processes:
                    if p.is_alive():
                        p.terminate()
                for p in procs.processes:
                    p.join(10)
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} still ran after "
                                   f"{timeout:.0f} s; terminated")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
