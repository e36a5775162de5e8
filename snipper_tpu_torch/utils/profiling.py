"""Profiling utilities: ``torch.profiler`` traces and a summary of the
device kernels by self time (the port's counterpart of
``snipper_tpu/utils/profiling.py``; the reference has none beyond the
wall-clock timing of its MetricLogger).

A trace is a Chrome trace file, ``{log_dir}/trace_{ns}.pt.trace.json``,
that ``chrome://tracing`` or Perfetto opens. :func:`summarize_trace` reads
the newest one. With a card, it sums the device lanes' events (kernels,
copies, memsets: ``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) by
kernel name. A trace without a device lane (a CPU run) falls back to the
host's ``cpu_op`` events. Either way it counts self time, JAX's algorithm:
events nest only within one (pid, tid) lane, and an event's direct
children are subtracted from it, so the times sum to the lanes' busy time
once.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Dict, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/trace'): run_steps()``. CUDA
    activity is recorded when a card is present; the caller synchronizes
    the card before the block ends so its kernels are in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.pt.trace.json"))


def _newest_trace(log_dir: str) -> Optional[str]:
    paths = glob.glob(os.path.join(log_dir, "*.pt.trace.json")) + \
        glob.glob(os.path.join(log_dir, "*.pt.trace.json.gz"))
    return max(paths, key=lambda p: (os.path.getmtime(p), p)) \
        if paths else None


def _events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    return tr["traceEvents"] if isinstance(tr, dict) else tr


def summarize_trace(log_dir: str, top_k: int = 15,
                    n_iters: int = 1) -> Dict[str, float]:
    """Self time by name from the newest trace in ``log_dir``: device
    events by kernel name, or, in a trace with none, ``cpu_op`` events by
    op name; returns ``{name: ms_per_iter}``, the ``top_k`` largest."""
    path = _newest_trace(log_dir)
    if path is None:
        return {}
    spans = [e for e in _events(path) if e.get("ph") == "X"]
    chosen = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if not chosen:  # no device lane: the host's operators
        chosen = [e for e in spans if e.get("cat") == "cpu_op"]
    # nesting only holds WITHIN one (pid, tid) lane: events on different
    # lanes (streams, threads) run concurrently, never parent and child
    lanes: Dict[tuple, list] = collections.defaultdict(list)
    for e in chosen:
        lanes[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), -float(e.get("dur", 0)), str(e["name"])))
    agg: Dict[str, float] = collections.Counter()
    for evs in lanes.values():
        evs.sort()
        stack = []  # (end_ts, name) of the enclosing events still open
        for ts, neg_dur, name in evs:
            dur = -neg_dur
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:  # direct child: subtract from the parent's self time
                agg[stack[-1][1]] -= dur / 1e3 / n_iters
            agg[name] += dur / 1e3 / n_iters
            stack.append((ts + dur, name))
    return dict(sorted(agg.items(), key=lambda kv: -kv[1])[:top_k])


def host_spans(log_dir: str, n_iters: int = 1) -> Dict[str, float]:
    """Host spans named with ``torch.profiler.record_function`` (``cat``
    ``user_annotation``; the profiler's own ``ProfilerStep#`` left out) in
    the newest trace in ``log_dir``, summed by name: ``{name:
    ms_per_iter}``. ``match_layers`` is the matching's host time."""
    path = _newest_trace(log_dir)
    if path is None:
        return {}
    agg: Dict[str, float] = collections.Counter()
    for e in _events(path):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and not str(e["name"]).startswith("ProfilerStep#"):
            agg[str(e["name"])] += float(e.get("dur", 0)) / 1e3 / n_iters
    return dict(agg)


class StepTimer:
    """Wall-clock per-step timer with warmup skip (MetricLogger-compatible
    numbers for quick throughput reports)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._t: Optional[float] = None
        self._n = 0

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
