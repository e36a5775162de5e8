"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter imports every module of ``snipper_tpu_torch`` and
``chip_smoke``; no ``jax``, ``flax``, ``optax``, ``orbax`` or
``snipper_tpu`` module may end up in ``sys.modules``, and neither may
matplotlib or PIL (the render and decode paths import them when they
run). The walk takes in every subpackage, ``data/preprocess`` among them.
A source scan finds no such import statement.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "snipper_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
FORBIDDEN = %r


class Block:
    # any import of a forbidden package raises, even one loaded at startup
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked import of " + name)


for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import snipper_tpu_torch
names = ["chip_smoke", "snipper_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(snipper_tpu_torch.__path__,
                                          "snipper_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
""" % (FORBIDDEN,)


def test_port_imports_no_jax_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "snipper_tpu_torch.cli.infer" in res["imported"]
    assert "snipper_tpu_torch.ops.msda" in res["imported"]
    for name in ("cli.train", "train.step", "train.engine", "losses.criterion",
                 "matching.matcher", "data.loader", "eval.metrics",
                 "ops.win2d", "ops.lane_chain", "ops.lsa", "scripts.probe",
                 "scripts.lanegather_probe", "scripts.kernel_ab",
                 "cli.eval", "data.device_preprocess", "infer.visualize",
                 "eval.posetrack_eval", "eval.coco_eval",
                 "eval.posetrack_writer", "data.datasets", "data.panoptic",
                 "data.camera", "data.native_ops", "data.preprocess",
                 "data.preprocess.common", "data.preprocess.posetrack",
                 "data.preprocess.mscoco", "data.preprocess.muco",
                 "data.preprocess.mupots", "data.preprocess.cmu_panoptic",
                 "data.preprocess.jta", "infer.fast", "infer.export",
                 "cli.export", "utils.profiling", "cli.dump_labels",
                 "data.preprocess.visualize", "scripts.parity_runbook",
                 "bench"):
        assert f"snipper_tpu_torch.{name}" in res["imported"], name
    leaked = [m for m in res["modules"]
              if m.split(".")[0] in FORBIDDEN + ("matplotlib", "PIL")]
    assert not leaked, leaked


def test_port_never_calls_embedding_bag():
    """``embedding_bag`` is chip_smoke.py's yardstick of the windowed
    kernels, never a path of the port: no source of the port (Python or
    CUDA) names it."""
    files = sorted(p for p in (REPO / "snipper_tpu_torch").rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh"))
    assert any(p.suffix == ".cu" for p in files)
    for path in files:
        assert "embedding_bag" not in path.read_text(), path


def test_port_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(?:from|import)\s+(?:%s)(?:[.\s]|$)" % "|".join(FORBIDDEN),
        re.MULTILINE)
    files = sorted((REPO / "snipper_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, (path, hits)


def test_cli_modules_run_as_scripts():
    """Each entry point answers ``python -m ... --help``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    for name in ("infer", "eval", "train"):
        proc = subprocess.run(
            [sys.executable, "-m", f"snipper_tpu_torch.cli.{name}", "--help"],
            cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, (name, proc.stderr)
        assert "--device" in proc.stdout, name
