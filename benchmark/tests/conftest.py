"""The benchmark's CPU tests: tiny shapes, no card. Tests that need the
card carry the ``cuda`` marker and skip inside the test without one."""

import json
import sys
from pathlib import Path
from unittest import mock

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a tiny model and small traffic for every cell, on the CPU
TINY = dict(num_frames=2, hidden_dim=96, enc_layers=1, dec_layers=2,
            dim_feedforward=128, num_queries=8, input_height=64,
            input_width=96, max_persons=4, nheads=4, backbone="resnet_test")
SMALL_TRAFFIC = {"frame_width": 160, "frame_height": 120, "pool_frames": 6,
                 "snippets_per_video": [2, 4], "check_snippets": 3,
                 "distinct_samples": 8, "trace_snippets": 2}
SEED = 2 ** 31 + 12345


def tiny_overrides(cell: str) -> dict:
    """The tiny model, small traffic, and the limits that the cell's
    limits file sets for this size from its own readings (``tiny``)."""
    from benchmark import harness

    cfg = dict(TINY)
    if not cell.startswith("serve"):
        cfg["num_future_frames"] = 1
    return {"config": cfg, "traffic": dict(SMALL_TRAFFIC),
            "limits": harness.limits_doc(cell)["tiny"]["limits"]}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def with_parked(man: dict) -> dict:
    """``man`` with the cells kept out of BENCHMARK.json for now
    (``benchmark/parked/<cell>.json``: the cell's entry and its metrics),
    so that their drivers, checks and readers stay tested. A parked metric
    that BENCHMARK.json also has adds its cells to that entry (one that
    lists no cells reports in every cell already)."""
    man = json.loads(json.dumps(man))
    for path in sorted((ROOT / "benchmark" / "parked").glob("*.json")):
        doc = json.loads(path.read_text())
        man["workloads"] += doc.get("workloads", [])
        for key in ("end_to_end", "per_layer"):
            have = {m["name"]: m for m in man[key]}
            for m in doc.get(key, []):
                if m["name"] not in have:
                    man[key].append(m)
                elif "workloads" in have[m["name"]]:
                    have[m["name"]]["workloads"] += m["workloads"]
    return man


def run_tiny(cell, trace=False, control=None, seconds=1.5, seed=SEED):
    import torch

    from benchmark import harness

    man = with_parked(harness.manifest())
    with mock.patch.object(harness, "manifest", lambda: man):
        return harness.run_cell(cell, seed, seconds, trace,
                                torch.device("cpu"), control,
                                overrides=tiny_overrides(cell))
