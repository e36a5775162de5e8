"""Smoothed training meters + stdout logging.

The port's own copy of ``snipper_tpu/utils/logger.py`` (reference
``util/misc.py`` ``SmoothedValue`` / ``MetricLogger``, ``:53-272``):
windowed medians/averages, iteration timing, ETA and periodic log lines,
with the peak device memory of the card.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


def _device_mem_mb():
    """Peak CUDA memory allocated by this process in MB, or None without a
    card (the reference's ``torch.cuda.max_memory_allocated()`` column,
    ``util/misc.py:254-262``)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self, group=None):
        """Sum each meter's count and total over the ranks of ``group``
        (reference ``util/misc.py:74-86``), so that ``global_avg`` is the
        average over every rank's updates; the windows stay local. Every
        rank must hold the same meters."""
        import torch
        import torch.distributed as dist

        from snipper_tpu_torch.parallel.multihost import (collective_device,
                                                          process_count)

        if process_count(group) == 1:
            return
        keys = sorted(self.meters)
        t = torch.tensor([[self.meters[k].count, self.meters[k].total]
                          for k in keys], dtype=torch.float64,
                         device=collective_device(group))
        dist.all_reduce(t, group=group)
        for k, (count, total) in zip(keys, t.tolist()):
            self.meters[k].count, self.meters[k].total = int(count), total

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", quiet: bool = False):
        """Yield from ``iterable``, printing a progress line every
        ``print_freq`` items and the total time at the end, unless
        ``quiet``."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 and not quiet:
                mem = _device_mem_mb()
                mem_s = f" max mem: {mem:.0f}MB" if mem is not None else ""
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i)))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} "
                          f"time: {iter_time} data: {data_time}{mem_s}",
                          flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} "
                          f"data: {data_time}{mem_s}", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        if quiet:
            return
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)", flush=True)
