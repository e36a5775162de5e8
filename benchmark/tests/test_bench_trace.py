"""The traced run's two sub-windows, the idle share read from the trace
alone, and an untraced run that leaves the program's names as they are."""

import pytest
import torch

from benchmark import harness
from benchmark.metrics import _common
from conftest import run_tiny


def test_two_sub_windows():
    """Units [1, 3) traced for the device, [3, 5) for the host; unit 5
    holds the export and is left out with them."""
    ctx = harness.Context(harness.workload("eval_t4f2_b2"), 7, 1.0, True,
                          torch.device("cpu"))
    for i in range(8):
        ctx.trace_tick(i, 1, 2)
        torch.ones(64, 64) @ torch.ones(64, 64)
    ctx.trace_close(8)
    assert ctx.data["trace"]["units"] == 2
    assert ctx.data["trace_host"]["units"] == 2
    assert not ctx.tracer.host or not ctx.tracer.running
    assert ctx.traced_mask(8).tolist() == [False] + [True] * 5 + [False] * 2
    assert ctx.traced_seconds() > 0


def test_window_closing_inside_a_sub_window():
    ctx = harness.Context(harness.workload("eval_t4f2_b2"), 7, 1.0, True,
                          torch.device("cpu"))
    for i in range(3):
        ctx.trace_tick(i, 1, 4)
    ctx.trace_close(3)
    assert ctx.data["trace"]["units"] == 2 and "trace_host" not in ctx.data


@pytest.mark.parametrize("busy,window,want", [
    (0.25, 1.0, 75.0), (0.0, 1.0, None), (1.2, 1.0, ValueError)])
def test_idle_share_from_the_trace_alone(busy, window, want):
    run = {"kind": "serve", "trace": {"busy_s": busy, "window_s": window,
                                      "units": 4}}
    if want is ValueError:
        with pytest.raises(ValueError):
            _common.idle_share(run, "serve")
    else:
        assert _common.idle_share(run, "serve") == want


def test_untraced_serving_patches_nothing():
    """The rate and its check read what serve_snippets returns; the
    program's own functions are not replaced in an untraced run."""
    from snipper_tpu_torch.cli import infer

    names = ("decode_predictions", "prefetched", "to_device")
    real = {n: getattr(infer, n) for n in names}
    seen = []
    serve = infer.serve_snippets

    def watched(*a, **k):
        seen.append(all(getattr(infer, n) is real[n] for n in names))
        return serve(*a, **k)

    infer.serve_snippets = watched
    try:
        r = run_tiny("serve_t4_hostwarp")
    finally:
        infer.serve_snippets = serve
    assert seen and all(seen)
    assert r["correct"] and r["attempted"] > 0


def test_device_busy_is_the_union_of_device_events():
    """The whole-window recording counts the device's own events once
    where they overlap, and leaves out host events and a span's range on
    the device's lane."""
    from types import SimpleNamespace
    from unittest import mock

    from torch.autograd import DeviceType

    from benchmark import tracing

    def ev(dev, a, d, note=False):
        return SimpleNamespace(device_type=lambda: dev, start_ns=lambda: a,
                               duration_ns=lambda: d,
                               is_user_annotation=lambda: note)

    events = [ev(DeviceType.CUDA, 0, 10), ev(DeviceType.CUDA, 5, 10),
              ev(DeviceType.CUDA, 40, 5), ev(DeviceType.CPU, 0, 100),
              ev(DeviceType.CUDA, 0, 100, note=True)]
    prof = mock.Mock()
    prof.profiler.kineto_results.events.return_value = events
    busy = tracing.DeviceBusy()
    busy.prof = prof
    out = busy.stop()
    assert out["busy_s"] == pytest.approx(20e-9) and out["events"] == 3
