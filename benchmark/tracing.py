"""The profiler over a traced sub-window, and its reduction: device busy
time, device self time by kernel name, idle gaps by the host span that was
open, and host spans by name.

A traced run takes two sub-windows in a row. The first records the device
alone (CUDA activity: kernels, copies, the runtime's launches), which slows
the host little, so its busy time over its length is the device's own
share. The second records the host's operators and spans as well, which
slows the host's enqueue; it serves only to label the idle gaps.

Device events are the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events; the busy time is the length of their union within the window. An
idle gap (no device event running) is labelled with the innermost host span
open at its midpoint among the benchmark's own (``bench.<name>``, from
``Context.span``) and the program's ``record_function`` spans; a gap under
none is ``unlabelled``. Self time per kernel: an event's direct children on
its lane are subtracted from it.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, device, host: bool):
        self.device = device
        self.host = host
        self.prof = None
        self.running = False

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.t_begin = time.perf_counter()
        acts = []
        if self.host or self.device.type != "cuda":
            acts.append(ProfilerActivity.CPU)
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.running = True

    def stop(self, units: int) -> dict:
        t1 = time.perf_counter()
        self.prof.stop()
        self.running = False
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        events = events["traceEvents"] if isinstance(events, dict) \
            else events
        out = reduce(events)
        out["window_s"] = t1 - self.t0
        out["units"] = units
        # the whole time the tracing held the loop, its start and its
        # export included: the untraced rate leaves it out
        out["span_s"] = time.perf_counter() - self.t_begin
        return out


class DeviceBusy:
    """The device's activity alone (CUDA: kernels, copies, fills) over a
    whole window, reduced in memory to its busy seconds: no export, no
    host operators recorded, so the host's enqueue runs as untraced."""

    def __init__(self):
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> dict:
        """``{"busy_s", "events", "stop_s"}``: the union of the device
        events' intervals, their count, and the seconds this stop took."""
        from torch.autograd import DeviceType

        t0 = time.perf_counter()
        self.prof.stop()
        spans = []
        for e in self.prof.profiler.kineto_results.events():
            # the device's own events (a range that a span marks on the
            # device's lane is not work)
            if e.device_type() == DeviceType.CUDA and not getattr(
                    e, "is_user_annotation", lambda: False)():
                a = e.start_ns()
                spans.append((a, a + e.duration_ns()))
        self.prof = None
        busy = _union(spans)
        return {"busy_s": sum(b - a for a, b in busy) / 1e9,
                "events": len(spans), "stop_s": time.perf_counter() - t0}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def reduce(events: List[dict]) -> dict:
    """Busy seconds, kernel self seconds by name, idle seconds by host
    span, host span seconds by name, from a Chrome trace's events (times
    in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    host = [e for e in spans if e.get("cat") == "user_annotation"
            and not str(e["name"]).startswith("ProfilerStep#")]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6

    lanes = collections.defaultdict(list)
    for e in dev:
        lanes[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), -float(e.get("dur", 0)), str(e["name"])))
    ops: Dict[str, float] = collections.Counter()
    for evs in lanes.values():
        evs.sort()
        stack = []
        for ts, neg, name in evs:
            dur = -neg
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                ops[stack[-1][1]] -= dur / 1e6
            ops[name] += dur / 1e6
            stack.append((ts + dur, name))

    span_s: Dict[str, float] = collections.Counter()
    hs = []
    for e in host:
        a, d = float(e["ts"]), float(e.get("dur", 0))
        span_s[str(e["name"])] += d / 1e6
        hs.append((a, a + d, str(e["name"])))
    gaps: Dict[str, float] = collections.Counter()
    for (a0, b0), (a1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (b0 + a1)
        inner = [h for h in hs if h[0] <= mid < h[1]]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else "unlabelled"
        gaps[label] += (a1 - b0) / 1e6
    return {"busy_s": busy_s, "ops": dict(ops), "spans": dict(span_s),
            "gaps": dict(gaps),
            "top_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "top_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10]}


def kernel_seconds(trace: dict, needle: str) -> float:
    """Device self seconds of the kernels whose name holds ``needle``."""
    return sum(v for k, v in trace["ops"].items() if needle in k)
