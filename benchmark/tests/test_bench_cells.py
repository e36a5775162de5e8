"""Every cell end to end on the CPU at a tiny size: the result line's keys,
``correct``, the metrics the manifest gives the cell; a new per-layer
metric needs only its file and its entry; no result without a card."""

import json
import os
import subprocess
import sys
from unittest import mock

import pytest

from benchmark import harness
from conftest import ROOT, run_tiny, with_parked

CELLS = [w["name"] for w in with_parked(harness.manifest())["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(cell):
    r = run_tiny(cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # a metric of the device's trace has no device to read on the CPU
    want = {m["name"] for m in harness.metrics_for(
        with_parked(harness.manifest()), cell, "end_to_end")
        if m["source"] != "device_trace"}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    json.dumps(r)


@pytest.mark.parametrize("cell", ["serve_t4_hostwarp", "train_t4f2_b2",
                                  "train_t4f2_b8"])
def test_cell_traced(cell):
    # six traced steps of batch 8 take 3-15 s on a loaded CPU; the rate
    # and the mfu need some untraced steps after them
    seconds = 25 if cell == "train_t4f2_b8" else 10
    r = run_tiny(cell, trace=True, seconds=seconds)
    assert r["correct"], r["checks"]
    assert "breakdown" in r and "window_s" in r["device"]
    # the host-side metrics read; the device's need a card
    train = {"train_data_wait_ms", "train_match_ms", "train_mfu"}
    host = {"serve_t4_hostwarp": {"serve_input_wait_ms",
                                  "serve_forward_ms", "serve_mfu",
                                  "serve_wall_snippets_per_s"},
            "train_t4f2_b2": train,
            "train_t4f2_b8": train | {"train_update_ms"}}[cell]
    assert host <= set(r["metrics"])


def test_new_metric_is_a_file_and_an_entry(tmp_path):
    """A per-layer metric added by a later change: its reader's file and
    its line in BENCHMARK.json, nothing else."""
    name = f"zz_throwaway_{os.getpid()}"
    path = harness.BENCH / "metrics" / f"{name}.py"
    path.write_text("def read(run):\n"
                    "    return float(len(run['wait_ms']))\n")
    man = harness.manifest()
    man["per_layer"].append({
        "name": name, "unit": "count", "better": "higher",
        "source": "program_span", "layer": "host input",
        "moves": "serve_device_ms_per_snippet",
        "workloads": ["serve_t4_hostwarp"]})
    try:
        with mock.patch.object(harness, "manifest", lambda: man):
            r = run_tiny("serve_t4_hostwarp", trace=True, seconds=2.5)
    finally:
        path.unlink()
    assert r["metrics"][name]["value"] > 0


def test_no_result_without_a_card():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "eval_t4f2_b2",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "eval_t4f2_b2",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "program under test is missing" in p.stderr


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on a card (skips without one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "serve_t4_hostwarp", "--seed", str(2 ** 31 + 99), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
