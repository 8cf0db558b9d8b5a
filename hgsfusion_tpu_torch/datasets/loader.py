"""Threaded prefetching batch loader (counterpart of
``hgsfusion_tpu/datasets/loader.py``).

The samples of a batch are built by a pool of threads (numpy augmentation,
padding, collation) while the previous batch trains on the device. The index
schedule comes from the loader's own generator, seeded from ``np.random`` at
construction, and batches come out in schedule order; the augmentations'
draws from the global ``np.random`` stream interleave across threads, as in a
multi-worker DataLoader. With ``pin_keys`` the named arrays of each batch are
copied into pinned host memory by the worker, so the consumer can copy them
to the card with ``non_blocking=True``.

Under data parallelism every rank builds the same schedule of global batches
(``world_size`` x ``batch_size`` frames, from one ``seed``) and takes the
``rank``-th contiguous slice of each, so W ranks see the frames that one
process sees at a batch of W x ``batch_size``.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


class _ProducerError:
    """A worker's exception, carried to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Collated batches from background workers through a prefetch queue.

    Args:
      dataset: indexable, with ``collate_batch(list_of_samples)``.
      batch_size: samples per batch.
      shuffle: a new permutation every epoch.
      num_workers: sample-building threads (0: built synchronously).
      prefetch: batches buffered ahead of the consumer.
      pin_keys: batch keys whose arrays are returned as pinned torch tensors.
      rank, world_size: this rank's slice of each global batch of
        ``world_size * batch_size`` frames.
      seed: the schedule's seed (default: drawn from ``np.random``); under
        data parallelism every rank must pass the same.

    Closing the generator of ``batches()`` stops its workers and waits for
    them.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 2, pin_keys=(), rank: int = 0,
                 world_size: int = 1, seed=None):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of a world of {world_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.pin_keys = tuple(pin_keys)
        self.rank, self.world_size = rank, world_size
        # the loader's own generator: the schedule depends on the caller's
        # seed only, not on what other threads draw from np.random
        self._rng = np.random.default_rng(np.random.randint(0, 2**31) if seed is None else seed)

    @property
    def global_batch_size(self) -> int:
        return self.batch_size * self.world_size

    def _epoch_order(self):
        n, g = len(self.dataset), self.global_batch_size
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        if g > n:
            # a batch larger than the dataset: top up with replacement so
            # that each epoch yields one batch
            order = np.concatenate([order, self._rng.integers(0, n, g - n)])
        return order

    def __len__(self):
        g = self.global_batch_size
        return max(len(self.dataset), g) // g

    def _schedule(self):
        """Endless index batches of this rank, epochs concatenated, the tail
        dropped."""
        g, lo = self.global_batch_size, self.rank * self.batch_size
        while True:
            order = self._epoch_order()
            for i in range(0, len(order) - g + 1, g):
                yield order[i + lo:i + lo + self.batch_size]

    def _finish(self, samples):
        batch = self.dataset.collate_batch(samples)
        for k in self.pin_keys:
            if k in batch:
                batch[k] = torch.from_numpy(batch[k]).pin_memory()
        return batch

    def batches(self) -> Iterator:
        """Endless stream of collated batches."""
        if self.num_workers <= 0:
            for idxs in self._schedule():
                yield self._finish([self.dataset[j] for j in idxs])
            return

        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        # batches submitted ahead, so that every worker has a sample to build
        ahead = -(-self.num_workers // self.batch_size)

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = collections.deque()
                    for idxs in self._schedule():
                        if stop.is_set():
                            break
                        pending.append([pool.submit(self.dataset.__getitem__, j) for j in idxs])
                        if len(pending) < ahead:
                            continue
                        if not put(self._finish([f.result() for f in pending.popleft()])):
                            break
                    # the consumer stopped: samples not started are not built
                    for f in (f for fs in pending for f in fs):
                        f.cancel()
            except Exception as exc:  # re-raised in the consumer
                put(_ProducerError(exc))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if isinstance(item, _ProducerError):
                    raise RuntimeError(
                        "PrefetchLoader worker failed while building a batch") from item.exc
                yield item
        finally:
            # the workers finish the samples in flight and draw nothing more
            stop.set()
            thread.join()
