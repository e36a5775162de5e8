"""The port's preprocessing renders (``data/preprocess/visualize.py``)
against the JAX package's, on the fixtures of
``tests/test_preprocess_viz.py``: the same arrays, bit for bit, and the
same files under the same names (both draw with PIL in the same order)."""

import os

import numpy as np
import pytest
from PIL import Image

from snipper_tpu.data.preprocess import visualize as jviz
from snipper_tpu_torch.data.preprocess import visualize as tviz


def _person(x0, y0, n=15):
    k = np.zeros((n, 3))
    k[:, 0] = x0 + np.linspace(0, 30, n)
    k[:, 1] = y0 + np.linspace(0, 60, n)
    k[:, 2] = 1
    return k


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_joint15_names_match_jax():
    from snipper_tpu_torch.data.skeleton import NUM_JOINTS, SKELETON_EDGES

    assert tviz.JOINT15_NAMES == jviz.JOINT15_NAMES
    assert len(tviz.JOINT15_NAMES) == NUM_JOINTS
    assert tviz.SKELETON_EDGES == jviz.SKELETON_EDGES == SKELETON_EDGES


@pytest.mark.parametrize("all_pids", [None, [1, 3, 5, 7]])
def test_render_annotation_frame_matches_jax(tmp_path, all_pids):
    img = np.random.default_rng(0).integers(0, 255, (120, 160, 3), np.uint8)
    kpts = np.stack([_person(10, 10), _person(90, 30)])
    kpts[1, 4, 2] = 0   # one hidden joint
    outs = []
    for pkg, name in ((tviz, "port"), (jviz, "jax")):
        path = str(tmp_path / name / "f.jpg")
        outs.append(pkg.render_annotation_frame(img.copy(), kpts, [3, 7],
                                                path, all_pids=all_pids))
        assert os.path.exists(path)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].sum() != img.sum()
    assert (tmp_path / "port" / "f.jpg").read_bytes() == \
        (tmp_path / "jax" / "f.jpg").read_bytes()


def _sequence(root, key, n_joints=15):
    root.mkdir()
    frames = []
    for i in range(3):
        name = f"{i:03d}.jpg"
        Image.fromarray(np.full((60, 80, 3), 40 * i, np.uint8)).save(
            root / name)
        fr = {"filename": name,
              "kpts2d": np.stack([_person(5 + i, 5, n_joints),
                                  _person(40, 2 + i, n_joints)])}
        if key:
            fr[key] = np.array([4, 9])
        frames.append(fr)
    return frames


@pytest.mark.parametrize("key,n_joints,max_frames", [
    ("track_ids", 15, 2), ("track_id", 15, 0), ("track_id", 18, 0)],
    ids=["track_ids", "singular_track_id", "posetrack18"])
def test_render_sequence_matches_jax(tmp_path, key, n_joints, max_frames):
    """Stable palette over the sequence's ids, the singular ``track_id``
    of the PoseTrack extractor, and the extractor's 18-joint records
    remapped to JOINT15."""
    frames = _sequence(tmp_path / "imgs", key, n_joints)
    written = {}
    for pkg, name in ((tviz, "port"), (jviz, "jax")):
        paths = pkg.render_sequence(frames, str(tmp_path / "imgs"),
                                    str(tmp_path / name), name="seq",
                                    max_frames=max_frames)
        written[name] = [os.path.relpath(p, tmp_path / name) for p in paths]
    assert written["port"] == written["jax"]
    assert len(written["port"]) == (max_frames or 3)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for rel in written["port"]:
        got = np.asarray(Image.open(tmp_path / "port" / rel))
        want = np.asarray(Image.open(tmp_path / "jax" / rel))
        np.testing.assert_array_equal(got, want)


def test_render_sequence_without_ids(tmp_path):
    """Records without ids: the port numbers each frame's people and
    renders each frame as render_annotation_frame does with those ids;
    the JAX package raises there (ROADMAP C, known difference)."""
    frames = _sequence(tmp_path / "imgs", None)
    with pytest.raises(ValueError):
        jviz.render_sequence(frames, str(tmp_path / "imgs"),
                             str(tmp_path / "jax"))
    paths = tviz.render_sequence(frames, str(tmp_path / "imgs"),
                                 str(tmp_path / "port"))
    assert len(paths) == 3
    img = np.asarray(Image.open(tmp_path / "imgs" / "000.jpg")
                     .convert("RGB"))
    want = jviz.render_annotation_frame(img, frames[0]["kpts2d"], [0, 1],
                                        str(tmp_path / "want.jpg"))
    np.testing.assert_array_equal(np.asarray(Image.open(paths[0])),
                                  np.asarray(Image.open(
                                      tmp_path / "want.jpg")))
    assert want.shape == img.shape


@pytest.mark.parametrize("n", [1, 2, 7, 60])
def test_pid_palette_matches_jax_without_matplotlib(n):
    """The port's palette computes matplotlib's ``rainbow`` table itself
    (the GPU host has no matplotlib): JAX's palette, value for value."""
    from snipper_tpu.infer.visualize import pid_palette as jax_palette
    from snipper_tpu_torch.infer.visualize import pid_palette

    got, want = pid_palette(n), jax_palette(n)
    assert [tuple(map(float, c)) for c in got] == \
        [tuple(map(float, c)) for c in want]
