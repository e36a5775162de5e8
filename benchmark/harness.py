"""The benchmark's general part: it finds a cell's files by the names in
``BENCHMARK.json``, runs the cell's driver once, reads the per-layer
metrics, and prints the result line.

Everything that belongs to one configuration, one traffic mix, one kind of
traffic or one per-layer metric sits in a file of its own, found by name:

- ``configs/<config>.json``: the model configuration as it is run;
- ``traffic/<traffic>.json``: the mix's parameters, among them ``kind``;
- ``drivers/<kind>.py``: the loop of that kind of traffic (``run(ctx)``);
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
- ``metrics/<metric>.py``: ``read(run) -> float | None``, a per-layer
  metric from what the run recorded.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "snipper_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, man: Optional[dict] = None) -> dict:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                     f"{[w['name'] for w in man['workloads']]}")


def config_doc(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def mix_doc(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits_doc(name: str) -> dict:
    return load_json(BENCH / "limits" / f"{name}.json")


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(man: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports: those that list
    it, and those that list no cells."""
    return [m for m in man[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, flax's
    or the JAX package's (``snipper_tpu_torch`` is not ``snipper_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Context:
    """What a driver gets: the cell's documents, the run's arguments, the
    device, and the hooks that time set-up, close the window and trace."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, control: Optional[str] = None,
                 overrides: Optional[dict] = None, t_start: float = None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.control = control
        overrides = overrides or {}
        self.cfg_doc = config_doc(cell["config"])
        self.cfg = dict(self.cfg_doc["config"], **overrides.get("config", {}))
        self.mix = dict(mix_doc(cell["traffic"]),
                        **overrides.get("traffic", {}))
        self.limits = overrides.get("limits") or \
            limits_doc(cell["name"])["limits"]
        self.t_start = t_start if t_start is not None else time.perf_counter()
        self.setup_s = None
        self.memory_peak = None
        self.data: Dict = {"cfg": self.cfg, "kind": self.mix["kind"]}
        self.tracer = None
        self.traced_units = (0, 0)
        self._trace_from = 0
        self.cache = CACHE
        self.marks: Dict[str, float] = {}
        self.t_closed = None
        self._usage = None

    def mark(self, name: str):
        """Seconds since the process started, at the end of a part of
        set-up (reported beside ``setup_s`` as ``setup_parts``)."""
        self.marks[name] = time.perf_counter() - self.t_start

    # ---- phases -----------------------------------------------------------
    def setup_done(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        self._usage = _usage()

    def window_closed(self):
        import torch

        self.sync()
        self.t_closed = time.perf_counter()
        if self._usage is not None:
            # the CPU seconds this process took in the window
            end = _usage()
            self.data["window_host"] = {k: end[k] - self._usage[k]
                                        for k in end}
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))
        else:
            self.memory_peak = 0

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self):
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- tracing ----------------------------------------------------------
    def span(self, name: str):
        """A host span of the benchmark's own around a call into a layer;
        recorded only in the host sub-window of a traced run."""
        if self.tracer is None or not (self.tracer.running
                                       and self.tracer.host):
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"bench.{name}")

    def trace_tick(self, i: int, first: int, units: int):
        """Called as unit ``i`` of the window starts. In a traced run the
        device sub-window covers units ``[first, first + units)`` and the
        host sub-window the next ``units``; the profiler's export falls
        into unit ``first + 2 * units``, which is left out with them."""
        if not self.trace:
            return
        self.traced_units = (first, first + 2 * units + 1)
        if i == first:
            self._trace_begin(i, host=False)
        elif i == first + units:
            self._trace_end(units)
            self._trace_begin(i, host=True)
        elif i == first + 2 * units:
            self._trace_end(units)

    def trace_close(self, i: int):
        """At the window's close, as unit ``i`` would start: a sub-window
        still open ends with the units it covered."""
        if self.tracer is not None and self.tracer.running:
            self._trace_end(i - self._trace_from)

    def _trace_begin(self, i: int, host: bool):
        from benchmark import tracing

        self.sync()
        self.tracer = tracing.Tracer(self.device, host)
        self.tracer.start()
        self._trace_from = i

    def _trace_end(self, units: int):
        self.sync()
        key = "trace_host" if self.tracer.host else "trace"
        self.data[key] = self.tracer.stop(units)

    def traced_mask(self, n: int):
        """Which of the window's first ``n`` units a sub-window touched."""
        import numpy as np

        mask = np.zeros(n, bool)
        if "trace" in self.data:
            a, b = self.traced_units
            mask[a:b] = True
        return mask

    def traced_seconds(self) -> float:
        """The time the sub-windows held the loop, exports included."""
        return sum(self.data[k]["span_s"] for k in ("trace", "trace_host")
                   if k in self.data)


@contextlib.contextmanager
def spans_around(ctx: Context, calls):
    """In a traced run, every call of ``module.name`` runs inside the host
    span ``label``; with ``each`` the call returns an iterator, and each
    item it yields is waited for inside the span. ``calls``: ``(module,
    name, label, each)``. These spans only label the breakdown's idle
    gaps: a name the program no longer has is passed over, and an
    untraced run patches nothing."""
    from unittest import mock

    def wrap(fn, label, each):
        def call(*a, **k):
            with ctx.span(label):
                return fn(*a, **k)

        def items(*a, **k):
            it = iter(fn(*a, **k))
            while True:
                with ctx.span(label):
                    x = next(it, _END)
                if x is _END:
                    return
                yield x

        return items if each else call

    with contextlib.ExitStack() as stack:
        if ctx.trace:
            for mod, name, label, each in calls:
                if not callable(getattr(mod, name, None)):
                    continue
                stack.enter_context(mock.patch.object(
                    mod, name, wrap(getattr(mod, name), label, each)))
        yield


_END = object()


def _usage() -> Dict[str, float]:
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": r.ru_utime, "sys_s": r.ru_stime}


def untraced_rate(count: int, seconds: float, ctx: "Context"
                  ) -> Optional[float]:
    """Units per second outside the tracing's sub-windows, None when too
    little of the window was left untraced to tell."""
    window = seconds - ctx.traced_seconds()
    if window < 1.0 or count < 1:
        return None
    return count / window


def device_info(ctx: Context) -> dict:
    import torch

    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": ctx.memory_peak or 0}
    info = {"platform": "gpu",
            "kind": torch.cuda.get_device_name(ctx.device),
            "count": int(ctx.cell["chips"]),
            "memory_peak_bytes": ctx.memory_peak}
    return info


def card_limits() -> Optional[str]:
    """The card's name and power limit by ``nvidia-smi``, None without
    one."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             control: Optional[str] = None, overrides: Optional[dict] = None,
             t_start: float = None) -> dict:
    """Run one cell once; returns the result line's object."""
    man = manifest()
    cell = workload(name, man)
    ctx = Context(cell, seed, seconds, trace, device, control, overrides,
                  t_start)
    ctx.mark("imports")
    out = driver(ctx.mix["kind"]).run(ctx)
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] and math.isfinite(c["value"])
                  for c in checks.values()) and out["failed"] == 0
    metrics = {}
    if not trace:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in metrics_for(man, name, "end_to_end"):
            if m["name"] in values and values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in metrics_for(man, name, "per_layer"):
            v = metric_reader(m["name"])(ctx.data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info(ctx)}
    if trace and "trace" in ctx.data:
        tr = ctx.data["trace"]
        # busy and window of the device sub-window; the gaps by host span
        # of the host sub-window
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["device"]["card"] = card_limits()
        gaps = ctx.data.get("trace_host", tr)["top_gaps"]
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in tr["top_ops"]],
            "idle_gaps": [[k, v] for k, v in gaps]}
    result["setup_parts"] = ctx.marks
    result["diag"] = out.get("diag", {})
    if "window_host" in ctx.data:
        result["diag"]["window_host"] = ctx.data["window_host"]
    if trace:
        # seconds a unit took in each sub-window and outside them: what
        # the tracing costs the host
        period = {k: ctx.data[k]["window_s"] / ctx.data[k]["units"]
                  for k in ("trace", "trace_host")
                  if ctx.data.get(k, {}).get("units")}
        if ctx.data.get("rate_untraced"):
            period["untraced"] = 1.0 / ctx.data["rate_untraced"]
        result["diag"]["unit_s"] = period
    result["check_s"] = time.perf_counter() - ctx.t_closed
    if control:
        result["control"] = control
    result["checks"] = checks
    return result
