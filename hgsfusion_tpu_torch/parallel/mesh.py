"""Data-parallel training over processes (counterpart of
``hgsfusion_tpu/parallel/mesh.py``: ``make_mesh`` and ``shard_batch``).

The JAX package trains over a 1-D ``data`` mesh of every local device: the
parameters are replicated, the global batch is split along its first axis,
and the gradient all-reduce and the BatchNorm statistics over the global
batch (SyncBN semantics) are collectives that XLA inserts. The port runs one
process per card under ``torchrun``:

- ``init_distributed`` joins the process group that torchrun's environment
  describes (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL on CUDA, gloo on the CPU, on ``cuda:LOCAL_RANK``;
- ``wrap_model`` puts the trainable model under ``DistributedDataParallel``,
  which averages the gradients over the ranks;
- ``rank_slice`` is the rank's contiguous slice of a global batch;
- the BatchNorms of ``models/layers.py`` reduce their train-mode statistics
  over the group themselves (``sync_group_size``).

``make_mesh_2d`` and ``spatial_batch_sharding`` (data x spatial meshes) are
not ported: nothing in the JAX package or its tools calls them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DistContext:
    """This process's place in the job: its rank, the world size, its rank
    on this host, its device and the group's backend (None: no group)."""
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: Optional[str]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def active(self) -> bool:
        """A process group is set up (torchrun started this process)."""
        return self.backend is not None


def init_distributed(device: str = "cuda", backend: Optional[str] = None, init_method=None,
                     timeout=None) -> DistContext:
    """Join torchrun's process group, or describe a lone process when the
    environment names none. ``device`` is the entry point's ``--device``:
    "cuda" gives each process ``cuda:LOCAL_RANK`` (one card a process; more
    local processes than cards raise), "cuda:i" puts the process on card i
    as asked (ranks that share a card must talk over gloo: NCCL refuses
    two ranks on one card); ``backend`` defaults to NCCL on CUDA and gloo
    on the CPU. ``init_method`` and ``timeout`` go to
    ``init_process_group`` (default: torchrun's environment, its timeout)."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return DistContext(0, 1, 0, dev, None)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu "
                               "to run on the CPU")
        if dev.index is None:
            if local >= torch.cuda.device_count():
                raise RuntimeError(f"local rank {local} has no card of its own: this host "
                                   f"has {torch.cuda.device_count()}; start at most that "
                                   f"many processes a host")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                **kw)
    return DistContext(rank, world, local, dev, backend)


def shutdown(ctx: DistContext):
    """Leave the process group ``init_distributed`` joined."""
    if ctx.active and dist.is_initialized():
        dist.destroy_process_group()


def sync_group_size() -> int:
    """The number of processes whose BatchNorm statistics are reduced
    together: the default group's size, 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def wrap_model(model, ctx: DistContext):
    """``model`` under ``DistributedDataParallel`` over the job's group, or
    None without one. Build the optimizer first: DDP takes the parameters
    that require a gradient when it is made, and the frozen backbone's do
    not. Every other one must get a gradient in every step
    (``find_unused_parameters=False``); those that the model names in
    ``parameters_without_grad()`` are left out of the reduction (their
    gradient stays None on every rank). The BatchNorms keep their running
    statistics equal on every rank themselves, so DDP broadcasts no
    buffer."""
    if not ctx.active:
        return None
    from torch.nn.parallel import DistributedDataParallel

    ignore = getattr(model, "parameters_without_grad", list)()
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(model, ignore)
    return DistributedDataParallel(
        model, device_ids=[ctx.device.index] if ctx.device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False)


def _per_frame(v) -> bool:
    return isinstance(v, list) or getattr(v, "ndim", 0) >= 1


def rank_slice(batch: dict, rank: int, world_size: int) -> dict:
    """Rank ``rank``'s contiguous slice of a global batch: every array or
    tensor and every per-frame list along its first axis, ``batch_size``
    the slice's size. The global size must divide by ``world_size``."""
    total = batch.get("batch_size") or len(next(v for v in batch.values() if _per_frame(v)))
    if total % world_size:
        raise ValueError(f"a global batch of {total} does not split over {world_size} ranks")
    per = total // world_size
    out = {k: v[rank * per:(rank + 1) * per] if _per_frame(v) else v for k, v in batch.items()}
    if "batch_size" in batch:
        out["batch_size"] = per
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, with the sum's gradient summed over the group in
    the backward pass (as SyncBatchNorm's backward reduces its statistics'
    gradients): every rank's loss reaches every rank's input."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x):
    """``x`` summed over the default group, differentiably."""
    return _AllReduceSum.apply(x)


def all_reduce_mean_(x):
    """``x`` averaged over the default group in place (no gradient); x
    itself without a group of more than one."""
    n = sync_group_size()
    if n > 1:
        dist.all_reduce(x)
        x.div_(n)
    return x
