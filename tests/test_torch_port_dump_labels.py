"""The port's label dump (``cli/dump_labels.py``) against the JAX
package's on the reference-format fixtures of
``tests/test_torch_port_datasets.py``: the same pickle (targets within
1e-6, the loader parity bound), the same statistics lines, and with
``--vis`` the same render file names."""

import os
import pickle
import sys

import pytest

from snipper_tpu.cli import dump_labels as jax_cli
from snipper_tpu_torch.cli import dump_labels as port_cli
from test_torch_port_datasets import (  # noqa: F401 (fixtures)
    assert_same_value, jta_fixture, posetrack_fixture)


def _stats(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("persons/sample", "visible-joint",
                              "mean normalized", "0 samples"))
            or ln.endswith(" samples")]


@pytest.mark.parametrize("source,mode,vis", [("posetrack", "val", 2),
                                             ("jta", "train", 0)])
def test_dump_labels_matches_jax(source, mode, vis, request, tmp_path,
                                 monkeypatch, capsys):
    root = request.getfixturevalue(f"{source}_fixture")
    outs = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        args = ["--preset", "tiny", f"--{source}_dir", root, "--mode", mode,
                "--limit", "3", "--out", str(d / "gt.pkl"), "--vis",
                str(vis), "--vis_dir", str(d / "vis")]
        os.makedirs(d)
        if name == "port":
            res = port_cli.main(args)
        else:
            monkeypatch.setattr(sys, "argv", ["dump_labels"] + args)
            jax_cli.main()
        with open(d / "gt.pkl", "rb") as f:
            dumps = pickle.load(f)
        outs[name] = (dumps, _stats(capsys.readouterr().out),
                      sorted(os.listdir(d / "vis"))
                      if os.path.isdir(d / "vis") else [])
    (got, got_lines, got_vis), (want, want_lines, want_vis) = \
        outs["port"], outs["jax"]
    assert len(want) == res["samples"] == len(got) >= 2
    assert_same_value(got, want, "dumps")
    assert got_lines == want_lines
    assert any(ln.startswith("persons/sample") for ln in got_lines)
    assert got_vis == want_vis
    if vis:
        assert "0000_aug_t0.jpg" in got_vis and "0001_aug_trans.jpg" in got_vis
