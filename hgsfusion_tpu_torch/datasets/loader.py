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

    Closing the generator of ``batches()`` stops its workers and waits for
    them.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 2, pin_keys=()):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.pin_keys = tuple(pin_keys)
        # the loader's own generator: the schedule depends on the caller's
        # seed only, not on what other threads draw from np.random
        self._rng = np.random.default_rng(np.random.randint(0, 2**31))

    def _epoch_order(self):
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        if self.batch_size > n:
            # a batch larger than the dataset: top up with replacement so
            # that each epoch yields one batch
            order = np.concatenate([order, self._rng.integers(0, n, self.batch_size - n)])
        return order

    def __len__(self):
        return max(len(self.dataset), self.batch_size) // self.batch_size

    def _schedule(self):
        """Endless index batches, epochs concatenated, the tail dropped."""
        while True:
            order = self._epoch_order()
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                yield order[i:i + self.batch_size]

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
