"""Merging a multi-process evaluation (counterpart of
``hgsfusion_tpu/parallel/multihost.py``).

Each process evaluates a strided shard of the frames
(``shard_indices_for_host``, torch ``DistributedSampler``'s semantics); the
per-frame annotations are gathered and zip-interleaved back into frame
order (``merge_anno_lists_across_hosts``) and the recall counts summed
(``allreduce_host_scalars``) before the official evaluation. The JAX package
rendezvous through pickles in a shared directory; here
``torch.distributed.all_gather_object`` carries the parts, and the merged
list is the same. ``merge_detections_across_hosts`` is not ported: nothing
in the JAX package's tools calls it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch.distributed as dist


def process_group():
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_indices_for_host(num_frames: int, process: Optional[int] = None,
                           num_processes: Optional[int] = None) -> List[int]:
    """Frame indices one process evaluates: a STRIDED shard over the
    wrap-padded index list, exactly torch DistributedSampler's semantics
    (pad to per*n with indices from the start, then indices[rank::n]), so
    every shard has the same length and the zip-interleaved merge lines up;
    the duplicate pad frames fall off at the merge's truncation.
    ``process`` / ``num_processes`` default to the default group's."""
    rank, world = process_group()
    p = rank if process is None else process
    n = world if num_processes is None else num_processes
    if num_frames == 0:
        return []
    per = (num_frames + n - 1) // n
    idxs = list(range(num_frames))
    # the whole list repeated as often as needed (DistributedSampler's
    # indices * ceil(pad / len)): a single slice of padding under-fills
    # when num_frames < n and leaves the shards unequal
    target = per * n
    idxs = (idxs * ((target + num_frames - 1) // num_frames))[:target]
    return idxs[p::n]


def is_padding(num_frames: int, process: int, num_processes: int) -> List[bool]:
    """Per entry of ``shard_indices_for_host(num_frames, process,
    num_processes)``: whether it is a wrap-padding duplicate (its place in
    the padded list is past ``num_frames``), which the merge drops."""
    per = -(-num_frames // num_processes) if num_frames else 0
    return [j * num_processes + process >= num_frames for j in range(per)]


def merge_anno_lists_across_hosts(part: List, num_frames: int) -> List:
    """Every process's per-frame list in frame order: gather the parts,
    zip-interleave them (the inverse of the strided shards) and truncate
    the wrap padding to ``num_frames``. One process: ``part`` truncated."""
    _, n = process_group()
    if n == 1:
        return part[:num_frames]
    parts = [None] * n
    dist.all_gather_object(parts, part)
    merged = [x for tup in zip(*parts) for x in tup]
    return merged[:num_frames]


def allreduce_host_scalars(values: Dict[str, float]) -> Dict[str, float]:
    """Python scalars summed over the processes (the recall counts); a copy
    of ``values`` for one process."""
    _, n = process_group()
    if n == 1:
        return dict(values)
    parts = [None] * n
    dist.all_gather_object(parts, {k: float(v) for k, v in values.items()})
    return {k: sum(p[k] for p in parts) for k in sorted(values)}
