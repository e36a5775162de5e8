"""``snipper_tpu_torch/ops/_build.py`` rebuilds a kernel library when its
source or a header the source includes is newer than the library, and
only then. nvcc is not needed: ``find_nvcc`` and ``subprocess.run`` are
replaced by stand-ins that record the command and write the library."""

import os
import subprocess

import pytest

from snipper_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree ``k.cu`` -> ``a.cuh`` -> ``b.cuh`` in a temporary
    ``ops/csrc`` and build directory; returns the list of nvcc calls."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n'
                              'int f() { return g(); }\n')
    (src / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n'
                               'int g() { return h(); }\n')
    (src / "b.cuh").write_text("#pragma once\nint h() { return 1; }\n")
    (src / "unused.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("library")
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info",
                                           stderr="")

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    return calls


def _age(path, seconds):
    """Set ``path``'s mtime ``seconds`` after the library's."""
    lib = _build.BUILD_DIR / "libk.so"
    t = lib.stat().st_mtime + seconds
    os.utime(path, (t, t))


def test_dependencies_follow_quoted_includes(csrc):
    assert [p.name for p in _build.dependencies("k.cu")] == \
        ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("touched", ["k.cu", "a.cuh", "b.cuh"])
def test_newer_source_or_header_rebuilds(csrc, touched):
    first = _build.build("k.cu", "libk.so")
    assert len(csrc) == 1 and first["log"] == "ptxas info"
    _age(_build.CSRC / touched, 10)
    again = _build.build("k.cu", "libk.so")
    assert len(csrc) == 2 and again["log"] == "ptxas info"


@pytest.mark.parametrize("touched", ["a.cuh", "unused.cuh"])
def test_older_or_unrelated_header_does_not_rebuild(csrc, touched):
    _build.build("k.cu", "libk.so")
    _age(_build.CSRC / touched, -10 if touched == "a.cuh" else 10)
    again = _build.build("k.cu", "libk.so")
    assert len(csrc) == 1 and again == {
        "path": _build.BUILD_DIR / "libk.so", "seconds": 0.0, "log": ""}


def test_msda_sources_depend_on_their_common_header():
    for name in ("msda_forward.cu", "msda_backward.cu"):
        assert [p.name for p in _build.dependencies(name)] == \
            [name, "msda_common.cuh"]
