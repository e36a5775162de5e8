"""What the per-layer readers share: the traced window's numbers and the
roofline of the sampling kernels."""

from __future__ import annotations

from benchmark import tracing
from benchmark.counts import msda, peaks

VALUE_BYTES = {"float32": 4, "bfloat16": 2}


def traced(run: dict, kind: str):
    """The traced window of a run of ``kind`` that traced some units."""
    tr = run.get("trace")
    if run.get("kind") != kind or tr is None or tr["units"] < 1:
        return None
    return tr


def traced_host(run: dict, kind: str):
    """The host sub-window of a traced run of ``kind``: its spans."""
    tr = run.get("trace_host")
    if run.get("kind") != kind or tr is None or tr["units"] < 1:
        return None
    return tr


def idle_share(run: dict, kind: str):
    """The share of the device sub-window (CUDA activity only) in which
    the device ran nothing, from the trace alone: 1 - busy / window. A
    share outside 0-100% is a fault of the reading and fails the run."""
    tr = traced(run, kind)
    if tr is None or tr["busy_s"] <= 0:
        return None
    share = 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
    if not 0.0 <= share <= 100.0:
        raise ValueError(f"device idle share {share}% outside 0-100%: busy "
                         f"{tr['busy_s']} s in a window of {tr['window_s']} s")
    return share


def mfu(run: dict, kind: str):
    if run.get("kind") != kind or not run.get("rate_untraced"):
        return None
    peak = peaks.FLOP_PER_S[run["precision"]]
    return 100.0 * run["flops_per_unit"] * run["rate_untraced"] / peak


def mean(run: dict, key: str, kind: str):
    xs = run.get(key) if run.get("kind") == kind else None
    return sum(xs) / len(xs) if xs else None


def sampling_roofline(run: dict, kind: str, needle: str, backward: bool):
    """The counted least time of the traced units' sampling calls over the
    device time of the kernels named ``needle``, in %."""
    tr = traced(run, kind)
    if tr is None:
        return None
    seconds = tracing.kernel_seconds(tr, needle)
    if seconds <= 0:
        return None
    bound = msda.step_bound_s(
        run["cfg"], run["unit_batch"], VALUE_BYTES[run["precision"]],
        backward, peaks.HBM_BYTES_PER_S, peaks.FLOP_PER_S["float32"])
    return 100.0 * bound * tr["units"] / seconds
