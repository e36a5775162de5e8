"""The port's host ops (``data/native_ops.py`` over
``data/csrc/imageops.cpp``) against the JAX package's.

``warp_patch`` runs through the port's own library, which the host C++
compiler builds into ``snipper_tpu_torch/_build/``; it is held against
JAX's ``warp_patch`` (its C++ extension where built, else its numpy path)
and against the port's numpy path within 1e-5. ``lsa``/``lsa_pairs`` give
JAX's pairs where JAX's extension loads and scipy's optimal cost within
1e-9. ``warp_patch_exact`` (serving's warp) equals the numpy
``generate_patch_image`` bit for bit, in one thread or two, with a
compiler or without. The build rules (a rebuild when the source is
newer, a stand-in compiler) and the fallback rule (numpy and scipy, with
one warning, only when no compiler is found; a failed build or load
raises) are checked apart. Tests that need a real compiler skip when
none is found.
"""

import os
import shutil
import subprocess
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from snipper_tpu.data import native_ops as jnative
from snipper_tpu.data import transforms as jtransforms
from snipper_tpu_torch.data import native_ops
from snipper_tpu_torch.data.transforms import generate_patch_image
from snipper_tpu_torch.ops import _build
from test_torch_port_datasets import WARP_CASES

TOL_WARP = 1e-5
TOL_COST = 1e-9
# WARP_CASES, then a crop centred off the frame's corner, so that most of
# the patch reads the zero border
CASES = [(*c, 0.5) for c in WARP_CASES] + [(10.0, True, (1.1, 0.9, 1.0),
                                             -0.2)]


@pytest.fixture
def cxx():
    compiler = _build.find_cxx()
    if compiler is None:
        pytest.skip("no C++ compiler ($CXX, c++ or g++) on this host")
    return compiler


def _frame(seed, H=40, W=56, out=(32, 48), rot=0.0, centre=0.5):
    rng = np.random.default_rng(seed)
    out_h, out_w = out
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    scale = max(W / out_w, H / out_h) * rng.uniform(0.8, 1.2)
    trans = jtransforms.gen_trans_from_patch(
        W * centre, H * centre, out_w * scale, out_h * scale, out_w, out_h,
        rot)
    return img, trans


def _numpy_warp(monkeypatch, *args):
    with monkeypatch.context() as m:
        m.setattr(native_ops, "_lib", False)
        return native_ops.warp_patch(*args)


@pytest.mark.parametrize("rot,do_flip,color,centre", CASES)
def test_warp_matches_jax_and_numpy(cxx, monkeypatch, rot, do_flip, color,
                                    centre):
    img, trans = _frame(int(abs(rot)) + 3, rot=rot, centre=centre)
    args = (img, trans, (32, 48), do_flip, color)
    got = native_ops.warp_patch(*args)
    assert native_ops.have_native()
    assert native_ops.build_info["path"].startswith(str(_build.BUILD_DIR))
    assert got.dtype == np.float32 and got.shape == (32, 48, 3)
    np.testing.assert_allclose(got, jnative.warp_patch(*args), rtol=0,
                               atol=TOL_WARP)
    np.testing.assert_allclose(got, _numpy_warp(monkeypatch, *args), rtol=0,
                               atol=TOL_WARP)
    if centre < 0:
        assert (got == 0).mean() > 0.3  # the border is zero


def test_warp_rejects_bad_input(cxx):
    img, trans = _frame(0)
    with pytest.raises(ValueError, match="singular"):
        native_ops.warp_patch(img, np.zeros((2, 3)), (8, 8))
    with pytest.raises(ValueError, match=r"\[H,W,3\]"):
        native_ops.warp_patch(img[..., :2], trans, (8, 8))


def test_warp_threads_agree_with_one(cxx):
    """Four threads warping at once (the GIL released in the call) give the
    frames one thread gives."""
    frames = [_frame(s, H=120, W=160, out=(96, 128), rot=5.0 * s)
              for s in range(8)]

    def warp(f):
        return native_ops.warp_patch(f[0], f[1], (96, 128), True,
                                     (1.0, 0.9, 1.1))

    one = [warp(f) for f in frames]
    with ThreadPoolExecutor(4) as pool:
        four = list(pool.map(warp, frames))
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)


# serving's warp: (source H, W), output (h, w), crop scale over the cover
# scale, centre as shares of W and H, rotation
EXACT_CASES = {
    "zoom_out_zero_border": ((40, 56), (32, 48), 2.5, (0.5, 0.5), 0.0),
    "zoom_in": ((40, 56), (32, 48), 0.3, (0.5, 0.5), 0.0),
    "odd_sizes": ((37, 53), (29, 47), 1.0, (0.5, 0.5), 0.0),
    "off_centre_rotated": ((41, 57), (31, 45), 1.3, (0.2, 0.85), 17.0),
}


def _exact_case(name, seed=0):
    (H, W), (h, w), zoom, (cx, cy), rot = EXACT_CASES[name]
    img = np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)
    scale = max(W / w, H / h) * zoom
    trans = jtransforms.gen_trans_from_patch(W * cx, H * cy, w * scale,
                                             h * scale, w, h, rot)
    want = generate_patch_image(img, False, trans, (h, w)).astype(np.float32)
    return img, trans, (h, w), want


@pytest.mark.parametrize("name", list(EXACT_CASES))
def test_warp_patch_exact_equals_numpy(cxx, name):
    img, trans, shape, want = _exact_case(name)
    got = native_ops.warp_patch_exact(img, trans, shape)
    assert native_ops.have_native()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    # a snippet's frames in one call
    frames = np.stack([img, img[::-1, ::-1]])
    snippet = native_ops.warp_patch_exact(frames, trans, shape)
    assert snippet.shape == (2, *want.shape)
    assert np.array_equal(snippet[0], want)
    assert np.array_equal(snippet[1], generate_patch_image(
        frames[1], False, trans, shape).astype(np.float32))
    if name == "zoom_out_zero_border":
        assert (got == 0).mean() > 0.3


def test_warp_patch_exact_two_threads_agree_with_one(cxx):
    """Two threads warping at once (the GIL released in the call) give the
    frames one thread gives, each equal to the numpy warp."""
    cases = [_exact_case(name, seed) for seed in range(2)
             for name in EXACT_CASES]

    def warp(c):
        return native_ops.warp_patch_exact(c[0], c[1], c[2])

    one = [warp(c) for c in cases]
    with ThreadPoolExecutor(2) as pool:
        two = list(pool.map(warp, cases))
    for a, b, c in zip(one, two, cases):
        assert np.array_equal(a, b) and np.array_equal(a, c[3])


def test_warp_patch_exact_without_compiler_is_numpy():
    img, trans, shape, want = _exact_case("off_centre_rotated")
    with mock.patch.object(native_ops, "_lib", False):
        got = native_ops.warp_patch_exact(img, trans, shape)
        two = native_ops.warp_patch_exact(np.stack([img, img]), trans, shape)
    assert got.dtype == two.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(two, np.stack([want, want]))


def test_warp_patch_exact_rejects_bad_input():
    img, trans, shape, _ = _exact_case("odd_sizes")
    with pytest.raises(ValueError, match="uint8"):
        native_ops.warp_patch_exact(img.astype(np.float32), trans, shape)
    with pytest.raises(ValueError, match="uint8"):
        native_ops.warp_patch_exact(img[..., :2], trans, shape)
    with pytest.raises(ValueError, match="uint8"):
        native_ops.warp_patch_exact(img[0], trans, shape)


@pytest.mark.parametrize("shape", [(5, 9), (8, 8), (1, 4), (9, 5), (0, 3),
                                   (3, 0)])
def test_lsa_pairs_match_jax_and_scipy(cxx, shape):
    cost = np.random.default_rng(sum(shape)).uniform(0, 1, shape)
    rows, cols = native_ops.lsa_pairs(cost)
    assert rows.dtype == cols.dtype == np.int64
    assert len(rows) == len(set(rows)) == len(set(cols)) == min(shape)
    r, c = linear_sum_assignment(cost)
    assert abs(cost[rows, cols].sum() - cost[r, c].sum()) <= TOL_COST
    if jnative.have_native():  # JAX's extension: the same pairs
        jr, jc = jnative.lsa_pairs(cost)
        np.testing.assert_array_equal(rows, jr)
        np.testing.assert_array_equal(cols, jc)
    if shape[0] <= shape[1]:
        np.testing.assert_array_equal(native_ops.lsa(cost), cols)


def test_lsa_rejects_tall_cost(cxx):
    with pytest.raises(ValueError, match="rows <= cols"):
        native_ops.lsa(np.zeros((3, 2)))


def test_eval_callers_take_the_op():
    from snipper_tpu_torch.eval import metrics, posetrack_eval

    assert metrics.lsa_pairs is native_ops.lsa_pairs
    assert posetrack_eval.lsa_pairs is native_ops.lsa_pairs


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """A source in a temporary tree and a stand-in compiler that records
    each command and writes the library."""
    src = tmp_path / "op.cpp"
    src.write_text('#include "op.h"\nint f() { return 1; }\n')
    (tmp_path / "op.h").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    return src, calls


@pytest.mark.parametrize("touched", ["op.cpp", "op.h"])
def test_host_build_rebuilds_when_source_is_newer(stand_in, touched):
    src, calls = stand_in
    first = _build.build_host(src, "libop.so", "/usr/bin/c++")
    assert len(calls) == 1 and calls[0][:6] == ["/usr/bin/c++",
                                                *_build.CXX_FLAGS]
    assert first["command"] == "c++ " + " ".join(_build.CXX_FLAGS)
    again = _build.build_host(src, "libop.so", "/usr/bin/c++")
    assert len(calls) == 1 and again["seconds"] == 0.0
    assert again["path"] == first["path"]
    t = first["path"].stat().st_mtime + 10
    os.utime(src.parent / touched, (t, t))
    _build.build_host(src, "libop.so", "/usr/bin/c++")
    assert len(calls) == 2
    # another compiler (or host) builds a library of its own
    other = _build.build_host(src, "libop.so", "/usr/bin/g++")
    assert len(calls) == 3 and other["path"] != first["path"]


def test_no_compiler_falls_back_with_one_warning(monkeypatch):
    monkeypatch.setattr(native_ops, "_lib", None)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    img, trans = _frame(1, rot=17.0)
    args = (img, trans, (32, 48), True, (0.9, 1.1, 1.05))
    with pytest.warns(RuntimeWarning, match="no C\\+\\+ compiler"):
        got = native_ops.warp_patch(*args)
    assert native_ops.have_native() is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no second warning
        rows, cols = native_ops.lsa_pairs(1 - np.eye(3)[::-1])
        again = native_ops.warp_patch(*args)
    np.testing.assert_array_equal(got, again)
    np.testing.assert_array_equal(cols, [2, 1, 0])
    want = generate_patch_image(img, True, trans, (32, 48))
    want = np.clip(want * np.asarray((0.9, 1.1, 1.05)), 0, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fault", ["compile", "load"])
def test_broken_build_or_load_raises(cxx, tmp_path, monkeypatch, fault):
    """A compiler that fails, or a library that does not load, raises and
    never falls back to numpy."""
    monkeypatch.setattr(native_ops, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fault == "compile":
        bad = tmp_path / "imageops.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native_ops, "SOURCE", bad)
        expected = RuntimeError
    else:
        def refuse(path):
            raise OSError(f"cannot load {path}")

        monkeypatch.setattr(native_ops.ctypes, "CDLL", refuse)
        expected = OSError
    img, trans = _frame(2)
    with pytest.raises(expected):
        native_ops.warp_patch(img, trans, (8, 8))
    assert native_ops._lib is None  # not cached as "no compiler"
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_load_is_once_under_threads(cxx, monkeypatch):
    """Threads that reach the first call together build and load once."""
    monkeypatch.setattr(native_ops, "_lib", None)
    opened, barrier = [], threading.Barrier(4)
    real_open = native_ops._open

    def counting_open():
        opened.append(1)
        return real_open()

    monkeypatch.setattr(native_ops, "_open", counting_open)

    def first_call(_):
        barrier.wait(timeout=30)
        return native_ops.have_native()

    with ThreadPoolExecutor(4) as pool:
        assert all(pool.map(first_call, range(4)))
    assert len(opened) == 1
    assert shutil.which(native_ops.build_info["command"].split()[0])
