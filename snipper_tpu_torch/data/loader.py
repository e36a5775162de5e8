"""Batching + background prefetch for map-style datasets.

The port's own copy of ``snipper_tpu/data/loader.py``: ``DataLoader``
(``:27-143``), in which a thread collates host batches (two ahead) while
the card runs the previous step and ``num_workers`` threads decode the
samples of a batch, and ``device_prefetch`` (``:146-158``), which keeps the
next batch's copy to the card in flight while the current step runs.
A last partial batch is dropped unless ``drop_last=False``.
The process shard is passed in explicitly (``process_index``,
``process_count``); a single process reads the whole dataset. Every process
derives the same permutation from ``(seed, epoch)``, pads it by wrap-around
to a multiple of ``process_count`` and takes its strided slice (the
``DistributedSampler`` role, reference ``main.py:229-231``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from snipper_tpu_torch.data.snippet import stack_batch


def pin_batch(batch: Dict) -> Dict:
    """A copy of ``batch`` whose arrays (the images or the raw frames with
    their warp parameters, and the padded targets) are torch tensors in
    pinned host memory, so that their copy to the card does not block the
    host; ``meta`` stays as it is."""
    def pin(x):
        return torch.from_numpy(np.ascontiguousarray(x)).pin_memory()

    out = {k: pin(v) if isinstance(v, np.ndarray) else v
           for k, v in batch.items()}
    out["targets"] = {k: pin(v) for k, v in batch["targets"].items()}
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, num_workers: int = 0,
                 drop_last: bool = True, pin_memory: bool = False):
        """``pin_memory``: each batch's step inputs are pinned in the
        loader's thread (``pin_batch``), for a copy to the card that does
        not block."""
        if not 0 <= process_index < process_count:
            raise ValueError(f"need 0 <= process_index < process_count (got "
                             f"{process_index}, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.pin_memory = pin_memory
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count

    def _shard_len(self):
        # padded-by-wraparound shard length (identical on every process)
        n = len(self.dataset)
        return (n + self.process_count - 1) // self.process_count

    def __len__(self):
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)  # fresh per-epoch aug streams

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
                    batch = stack_batch(samples)
                    if self.pin_memory:
                        batch = pin_batch(batch)
                    if not put(batch):
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


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def device_prefetch(iterator: Iterator[Dict], put,
                    stream: Optional["torch.cuda.Stream"] = None
                    ) -> Iterator[Dict]:
    """Double-buffered host -> device feed: ``put`` (the copy of one host
    batch to the card, e.g. ``train/step.py::batch_to_device``) is issued
    for the next batch before the current one is handed out, so the next
    copy is in flight while the current step runs.

    Without ``stream``, each copy is queued on the current stream, behind
    the steps before it; from pinned memory (``DataLoader(pin_memory=
    True)``) with ``non_blocking=True`` it does not block the host.
    With ``stream`` (a side CUDA stream), each copy runs on that stream
    and overlaps the step on the current stream: an event recorded after
    the copy is waited on by the current stream before the batch is
    handed out, and every tensor of the batch is ``record_stream``-ed on
    the current stream, so that the caching allocator does not hand its
    memory to another tensor before the step that reads it is done."""
    def start(batch):
        if stream is None:
            return put(batch), None
        with torch.cuda.stream(stream):
            out = put(batch)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def finish(item):
        out, done = item
        if done is not None:
            current = torch.cuda.current_stream(stream.device)
            current.wait_event(done)
            for t in _tensors(out):
                t.record_stream(current)
        return out

    pending = None
    for batch in iterator:
        nxt = start(batch)
        if pending is not None:
            yield finish(pending)
        pending = nxt
    if pending is not None:
        yield finish(pending)
