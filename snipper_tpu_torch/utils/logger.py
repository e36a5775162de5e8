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

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
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
            if i % print_freq == 0:
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
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)", flush=True)
