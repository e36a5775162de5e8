"""BENCHMARK.json against its schema, and every file it names
found by name."""

import json
import re

import pytest

from benchmark import harness
from conftest import with_parked

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) < 64 * 1024
    configs = {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        doc = json.load(open(harness.ROOT / c["file"]))
        assert doc["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(doc["reduced"])
    used = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
        used.add(w["config"])
    assert used == configs
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    cells = [w["name"] for w in man["workloads"]]
    for m in man["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        # each cell a metric lists is a cell of the manifest that reports
        # the end-to-end metric it moves (the training metrics: the
        # batch-8 cell)
        moves = next(e for e in man["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells, (m["name"], cell)
            assert cell in moves.get("workloads", [cell]), (m["name"], cell)
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("parked", [False, True])
def test_every_cell_finds_its_files_by_name(parked):
    """The manifest's cells, and with ``parked`` also the cells kept out
    of it for now, which come back by their entries alone."""
    man = harness.manifest()
    if parked:
        man = with_parked(man)
    for w in man["workloads"]:
        mix = harness.mix_doc(w["traffic"])
        assert harness.driver(mix["kind"]).run
        assert harness.limits_doc(w["name"])["limits"]
        assert harness.config_doc(w["config"])["config"]
        reported = harness.metrics_for(man, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.metrics_for(man, w["name"], "per_layer")
    for m in man["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        # a reader that finds nothing to read returns nothing
        assert harness.metric_reader(m["name"])({"kind": "none"}) is None
