"""Batching + background prefetch for map-style datasets.

The port's own copy of ``snipper_tpu/data/loader.py::DataLoader``
(``:27-143``): a thread collates host batches (two ahead) while the card
runs the previous step, and ``num_workers`` threads decode the samples of
a batch. A last partial batch is dropped.
The process shard is passed in explicitly (``process_index``,
``process_count``); a single process reads the whole dataset. Every process
derives the same permutation from ``(seed, epoch)``, pads it by wrap-around
to a multiple of ``process_count`` and takes its strided slice (the
``DistributedSampler`` role, reference ``main.py:229-231``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from snipper_tpu_torch.data.snippet import stack_batch


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, num_workers: int = 0):
        if not 0 <= process_index < process_count:
            raise ValueError(f"need 0 <= process_index < process_count (got "
                             f"{process_index}, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count

    def _shard_len(self):
        # padded-by-wraparound shard length (identical on every process)
        n = len(self.dataset)
        return (n + self.process_count - 1) // self.process_count

    def __len__(self):
        return self._shard_len() // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        """This process's index shard for the current epoch."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.process_count > 1:
            total = self._shard_len() * self.process_count
            if total > idx.size:  # wrap-around padding, as DistributedSampler
                idx = np.concatenate([idx, idx[: total - idx.size]])
            idx = idx[self.process_index::self.process_count]
        return idx

    def __iter__(self) -> Iterator[Dict]:
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = object()
        cancelled = threading.Event()  # consumer abandoned the iterator

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone, so an
            early ``break`` mid-epoch does not leave this thread blocked on
            a full queue."""
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            pool = None
            try:
                if self.num_workers > 0:
                    from concurrent.futures import ThreadPoolExecutor

                    pool = ThreadPoolExecutor(self.num_workers)
                idx = self._indices()
                for b in range(len(self)):
                    if cancelled.is_set():
                        break
                    sel = [int(i) for i in
                           idx[b * self.batch_size:(b + 1) * self.batch_size]]
                    if pool is not None:
                        samples = list(pool.map(self.dataset.__getitem__,
                                                sel))
                    else:
                        samples = [self.dataset[i] for i in sel]
                    if not put(stack_batch(samples)):
                        break
            except BaseException as e:  # surface worker errors to consumer
                put(e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on exhaustion and on an early break: release the producer
            cancelled.set()
