"""The port's parity runbook and its console scripts.

On reference-named tiny weights, the JAX package's
``scripts/parity_runbook.py`` (loaded by path, ``--skip_reference``: the
activation leg alone) writes its goldens; the port's
``scripts/parity_runbook.py --against`` that directory then reports every
output within 1e-4 and writes ``report.json`` (the JAX runbook's keys)
and ``report.md``. The five ``snipper-torch-*`` console scripts of
``pyproject.toml`` resolve, exit 0 on ``--help`` and return None where
their CLI's ``main`` returns a result dict. The end-to-end eval leg on a
MuPoTS-format set is ``slow``, as JAX's ``tests/test_parity_runbook.py``.
"""

import importlib
import importlib.util
import json
import os
import pathlib
import sys
import tomllib

import numpy as np
import pytest
import torch

import jax

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu_torch.scripts import parity_runbook
from test_torch_parity import TorchSnipper, _reference_state_dict

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-4
TINY_FLAGS = ["--preset", "tiny"]


class _JitApply:
    """A flax module whose ``apply`` is jitted (one compile, not op-by-op
    dispatch on the CPU)."""

    def __init__(self, module):
        self._module = module
        self.apply = jax.jit(module.apply)

    def __getattr__(self, name):
        return getattr(self._module, name)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """An original-repo ``.pth`` of reference-named tiny weights."""
    torch.manual_seed(0)
    sd = _reference_state_dict(TorchSnipper(JaxConfig.tiny()).eval())
    path = tmp_path_factory.mktemp("ckpt") / "reference.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    return str(path)


@pytest.fixture(scope="module")
def jax_run(checkpoint, tmp_path_factory):
    """The JAX runbook's activation leg: its ``--output_dir``."""
    from snipper_tpu.models import snipper as jsnipper

    out = str(tmp_path_factory.mktemp("jax_runbook"))
    with pytest.MonkeyPatch.context() as m:
        # the script prepends the repo to PYTHONPATH and sys.path at import
        m.setenv("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
        m.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(
            "jax_parity_runbook", REPO / "scripts" / "parity_runbook.py")
        runbook = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(runbook)
        build = jsnipper.build_model
        m.setattr(jsnipper, "build_model", lambda cfg: _JitApply(build(cfg)))
        m.setattr(sys, "argv", ["parity_runbook.py", "--checkpoint",
                                checkpoint, *TINY_FLAGS, "--output_dir",
                                out, "--skip_reference"])
        runbook.main()
    return out


def test_runbook_matches_the_jax_runbook(checkpoint, jax_run, tmp_path):
    out = str(tmp_path / "torch_runbook")
    report = parity_runbook.main(["--checkpoint", checkpoint, *TINY_FLAGS,
                                  "--output_dir", out, "--against", jax_run,
                                  "--device", "cpu"])
    with open(os.path.join(jax_run, "report.json")) as f:
        jax_report = json.load(f)
    with open(os.path.join(out, "report.json")) as f:
        assert json.load(f) == report
    # JAX's keys, its activation table's shape, and one more key for the
    # reference's outputs (absent from a --skip_reference run)
    assert set(jax_report) <= set(report)
    assert report["reference_parity"].startswith("skipped (no ")
    ap = report["activation_parity"]
    goldens = np.load(os.path.join(jax_run, "goldens", "flax_outputs.npz"))
    assert set(ap) == set(goldens.files) >= set(parity_runbook.OUTPUTS)
    assert all(d["max_abs"] <= TOL for d in ap.values()), ap
    ours = np.load(os.path.join(out, "goldens", "torch_outputs.npz"))
    for k in goldens.files:
        np.testing.assert_allclose(ours[k], goldens[k], rtol=0, atol=TOL)
    theirs = np.load(os.path.join(jax_run, "goldens", "probe_input.npz"))
    mine = np.load(os.path.join(out, "goldens", "probe_input.npz"))
    np.testing.assert_array_equal(mine["x"], theirs["x"])
    with open(os.path.join(out, "report.md")) as f:
        md = f.read()
    assert "| pred_logits |" in md and "flax outputs" in md


def test_runbook_without_against_skips_the_comparison(checkpoint, tmp_path):
    report = parity_runbook.main(["--checkpoint", checkpoint, *TINY_FLAGS,
                                  "--output_dir", str(tmp_path),
                                  "--device", "cpu"])
    assert report["activation_parity"] == "skipped (no --against run)"
    assert (tmp_path / "goldens" / "torch_outputs.npz").exists()


def _console_scripts():
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items() if k.startswith("snipper-torch")}


@pytest.mark.parametrize("name,cli", [
    ("snipper-torch-train", "train"), ("snipper-torch-eval", "eval"),
    ("snipper-torch-infer", "infer"), ("snipper-torch-export", "export"),
    ("snipper-torch-dump-labels", "dump_labels")])
def test_console_scripts_exit_zero(name, cli, monkeypatch, capsys):
    """Each resolves, exits 0 on ``--help``, and returns None (exit 0) where
    the CLI's ``main`` returns its result dict."""
    module, attr = _console_scripts()[name].split(":")
    entry = getattr(importlib.import_module(module), attr)
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as exc:
        entry()
    assert exc.value.code == 0 and "usage" in capsys.readouterr().out
    target = importlib.import_module(f"snipper_tpu_torch.cli.{cli}")
    monkeypatch.setattr(target, "main", lambda: {"result": 1})
    assert entry() is None


@pytest.mark.slow
def test_runbook_eval_leg_end_to_end(checkpoint, tmp_path):
    """The MuPoTS eval leg through ``cli.eval`` in a subprocess: the 3D
    metric table in the report."""
    from test_eval_rehearsal import _mupots_raw

    from snipper_tpu_torch.data.preprocess import mupots

    raw = tmp_path / "mupots"
    os.makedirs(raw)
    _mupots_raw(raw, n_frames=40)
    mupots.extract(str(raw), str(raw))
    out = str(tmp_path / "parity")
    report = parity_runbook.main(["--checkpoint", checkpoint, *TINY_FLAGS,
                                  "--output_dir", out, "--mupots_dir",
                                  str(raw), "--device", "cpu"])
    ev = report["eval_mupots"]
    assert "error" not in ev, ev
    for key in ("mpjpe_root", "mpjpe_joint", "pel_mpjpe_joint", "3dpck"):
        assert key in ev and np.isfinite(ev[key]), (key, ev)
    assert os.path.exists(os.path.join(out, "report.md"))
