"""The per-layer metrics that read the program's own host spans: in a
traced tiny run of each cell, every one of them reads a number, and the
step's enqueue leaves out the matching nested in it."""

from unittest import mock

import pytest

from benchmark import harness
from conftest import run_tiny

METRICS = {
    "serve_t4_hostwarp": ("serve_upload_ms", "serve_enqueue_ms",
                          "serve_readback_ms", "serve_decode_ms"),
    "eval_t4f2_b2": ("eval_step_enqueue_ms", "eval_match_ms",
                     "eval_readback_ms", "eval_postprocess_ms",
                     "eval_metrics_ms"),
}


@pytest.mark.parametrize("cell", sorted(METRICS))
def test_program_span_metrics_read(cell):
    runs = []
    reader = harness.metric_reader

    def kept(name):
        read = reader(name)

        def spy(run):
            runs.append(run)
            return read(run)
        return spy

    with mock.patch.object(harness, "metric_reader", kept):
        r = run_tiny(cell, trace=True, seconds=10)
    assert r["correct"], r["checks"]
    for name in METRICS[cell]:
        assert r["metrics"][name]["value"] > 0, name
        assert r["metrics"][name]["unit"] == "ms"
    if cell == "eval_t4f2_b2":
        host = runs[0]["trace_host"]
        step_ms = 1e3 * host["spans"]["eval.step"] / host["units"]
        assert r["metrics"]["eval_step_enqueue_ms"]["value"] < step_ms
        assert r["metrics"]["eval_match_ms"]["value"] < step_ms


@pytest.mark.parametrize("name", sorted(n for ns in METRICS.values()
                                        for n in ns))
def test_program_span_metric_without_its_span(name):
    """A program without the span (the parent of this change) gives no
    number, and does not raise."""
    for kind in ("serve", "eval"):
        run = {"kind": kind, "trace_host": {"units": 3, "spans": {
            "bench.step": 0.01, "bench.forward": 0.01}}}
        assert harness.metric_reader(name)(run) is None
