"""The port's label extractors against the JAX package's on the raw
reference-format fixtures of ``tests/test_preprocess.py`` and
``tests/test_eval_rehearsal.py``: PoseTrack ``extract`` + ``fillin``
(train) and ``extract`` (val), COCO ``extract`` (train and val), the JTA
annotation split, listing and moving-camera exclusion, and the JTA frame
extraction through its cv2 fallback. Each package writes into its own
copy of the raw tree; the returns, the pickles and the JSON files must be
equal.

The fixture writers are copies of those tests'.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

from snipper_tpu.data.preprocess import jta as jjta
from snipper_tpu.data.preprocess import mscoco as jcoco
from snipper_tpu.data.preprocess import posetrack as jpt
from snipper_tpu_torch.data.preprocess import jta as tjta
from snipper_tpu_torch.data.preprocess import mscoco as tcoco
from snipper_tpu_torch.data.preprocess import posetrack as tpt
from test_torch_port_datasets import assert_same_value


def _img(path, w=120, h=90):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(path)


def _posetrack_train_raw(root):
    """tests/test_preprocess.py's PoseTrack train set: labeled frames 0..9,
    a gap, then 13..19."""
    ann_dir = root / "annotations" / "train"
    os.makedirs(ann_dir)
    rng = np.random.default_rng(0)
    images, annotations = [], []
    frame_ids = list(range(10)) + list(range(13, 20))
    for i in frame_ids:
        fn = f"images/train/000001_x/{i:06d}.jpg"
        _img(str(root / fn))
        img_id = 1000 + i
        images.append({"id": img_id, "file_name": fn, "is_labeled": True})
        for pid in (0, 1):
            k = rng.uniform(10, 80, (17, 3))
            k[:, 2] = 1
            annotations.append({
                "image_id": img_id, "track_id": pid, "category_id": 1,
                "id": img_id * 100 + pid,
                "keypoints": k.reshape(-1).tolist(),
                "bbox": [10, 10, 40, 60], "bbox_head": [10, 10, 10, 10]})
    # an unlabeled frame and an annotation with a keypoint far off the image
    images.append({"id": 2000, "file_name":
                   "images/train/000001_x/000020.jpg", "is_labeled": False})
    k = rng.uniform(10, 80, (17, 3))
    k[3, 0] = 1e5
    annotations.append({"image_id": 1005, "track_id": 2, "category_id": 1,
                        "id": 5, "keypoints": k.reshape(-1).tolist(),
                        "bbox": [10, 10, 40, 60]})
    with open(ann_dir / "000001_x.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1}]}, f)


def _posetrack_val_raw(root, video="000001_x", n_frames=16):
    """tests/test_eval_rehearsal.py's PoseTrack18 val annotations."""
    rng = np.random.default_rng(3)
    images, annotations = [], []
    base = {0: rng.uniform(20, 60, (17, 2)),
            1: rng.uniform(80, 140, (17, 2))}
    for i in range(n_frames):
        fn = f"images/val/{video}/{i:06d}.jpg"
        _img(str(root / fn), w=160, h=120)
        images.append({"id": 1000 + i, "file_name": fn, "is_labeled": True,
                       "vid_id": video, "frame_id": i})
        if i == 5:
            continue  # a labeled frame with nobody in it
        for tid in (0, 1):
            k = np.concatenate(
                [base[tid] + rng.uniform(-2, 2, (17, 2)),
                 np.ones((17, 1))], 1)
            annotations.append({
                "image_id": 1000 + i,
                "keypoints": k.reshape(-1).tolist(),
                "track_id": tid,
                "bbox": [10.0 + 60 * tid, 10.0, 50.0, 80.0],
                "bbox_head": [15.0 + 60 * tid, 10.0, 20.0, 20.0],
            })
    ann_dir = root / "annotations" / "val"
    os.makedirs(ann_dir, exist_ok=True)
    with open(ann_dir / f"{video}.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)


def _coco_raw(root, subset):
    rng = np.random.default_rng(1)
    images, annotations = [], []
    for i in range(3):
        fn = f"{i:012d}.jpg"
        _img(str(root / f"{subset}2017" / fn), w=200, h=150)
        images.append({"id": 100 + i, "file_name": fn})
        for a in range(2):
            k = rng.uniform(20, 140, (17, 3))
            k[:, 2] = 2  # COCO vis flag in {0,1,2}
            if a == 1 and i == 2:
                k[:, 2] = 0  # nobody visible: dropped
            annotations.append({
                "image_id": 100 + i, "category_id": 1, "id": i * 10 + a,
                "keypoints": k.reshape(-1).tolist(),
                "bbox": [-5, 5, 300, 100], "num_keypoints": 17})
    os.makedirs(root / "annotations", exist_ok=True)
    with open(root / "annotations" / f"person_keypoints_{subset}2017.json",
              "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)


def _both_trees(tmp_path, write):
    """The same raw tree written twice, one per package."""
    roots = []
    for name in ("port", "jax"):
        root = tmp_path / name
        os.makedirs(root)
        write(root)
        roots.append(root)
    return roots


def _same_pickles(port_root, jax_root, names):
    for name in names:
        with open(port_root / name, "rb") as f:
            got = pickle.load(f)
        with open(jax_root / name, "rb") as f:
            want = pickle.load(f)
        assert_same_value(got, want, name, 0.0)


def test_posetrack_train_extract_fillin_match_jax(tmp_path):
    port, jax_ = _both_trees(tmp_path, _posetrack_train_raw)
    got = tpt.extract(str(port), str(port), "train")
    want = jpt.extract(str(jax_), str(jax_), "train")
    assert_same_value(got, want, "extract", 0.0)
    got = tpt.fillin(str(port), "train")
    want = jpt.fillin(str(jax_), "train")
    assert_same_value(got, want, "fillin", 0.0)
    assert len(got["000001_x.json"]) == 20
    _same_pickles(port, jax_, ["train.pkl", "train_filled.pkl"])


def test_posetrack_val_extract_matches_jax(tmp_path):
    port, jax_ = _both_trees(tmp_path, _posetrack_val_raw)
    got = tpt.extract(str(port), str(port), "val")
    want = jpt.extract(str(jax_), str(jax_), "val")
    assert_same_value(got, want, "extract", 0.0)
    assert got["categories"] and got["000001_x.json"][5]["is_label"] is False
    _same_pickles(port, jax_, ["val.pkl"])


@pytest.mark.parametrize("subset", ["train", "val"])
def test_coco_extract_matches_jax(tmp_path, subset):
    port, jax_ = _both_trees(tmp_path, lambda r: _coco_raw(r, subset))
    got = tcoco.extract(str(port), str(port), subset)
    want = jcoco.extract(str(jax_), str(jax_), subset)
    assert_same_value(got, want, "extract", 0.0)
    assert [r["kpts2d"].shape[0] for r in got] == [2, 2, 1]
    _same_pickles(port, jax_, [f"coco_{subset}.pkl"])


def _jta_raw(root):
    """tests/test_preprocess.py's JTA annotation matrix (two subsets)."""
    rng = np.random.default_rng(2)
    for subset, seq in (("train", "seq_1"), ("test", "seq_7")):
        os.makedirs(root / "annotations" / subset)
        rows = []
        for frame in range(1, 11):          # raw frames are 1-based
            for pid in ((3, 5) if frame != 4 else (3,)):
                for j in range(22):
                    rows.append([frame, pid, j,
                                 *rng.uniform(0, 100, 2).tolist(),
                                 *rng.uniform(-2, 5, 3).tolist(),
                                 int(rng.integers(0, 2)), 0])
        with open(root / "annotations" / subset / f"{seq}.json", "w") as f:
            json.dump(rows, f)


def _tree_files(root, sub):
    base = root / sub
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def test_jta_split_and_listing_match_jax(tmp_path):
    port, jax_ = _both_trees(tmp_path, _jta_raw)
    for root, mod in ((port, tjta), (jax_, jjta)):
        mod.split_annotations(str(root), str(root), n_frames=10)
    files = _tree_files(port, "ann_split")
    assert files == _tree_files(jax_, "ann_split") and len(files) == 20
    for name in files:
        with open(port / "ann_split" / name) as f:
            got = json.load(f)
        with open(jax_ / "ann_split" / name) as f:
            assert got == json.load(f), name
    for root in (port, jax_):
        (root / "moving_camera_seq.txt").write_text("7\n12\n")
    got = tjta.prepare_listing(str(port), str(port))
    want = jjta.prepare_listing(str(jax_), str(jax_))
    assert got == want and got["test"] == {} and len(got["train"]["seq_1"]) \
        == 10
    name = "jta_all_ann_files_no_moving_camera.json"
    with open(port / name) as f, open(jax_ / name) as g:
        assert json.load(f) == json.load(g)
    got = tjta.prepare_listing(str(port), str(port),
                               exclude_moving_camera=False)
    assert got == jjta.prepare_listing(str(jax_), str(jax_),
                                       exclude_moving_camera=False)


def test_jta_listing_requires_exclusion_list(tmp_path):
    """Without the moving-camera list the fixed-camera listing raises, as
    JAX's does; the explicit opt-out lists every sequence."""
    root = tmp_path / "jta"
    os.makedirs(root / "ann_split" / "train" / "seq_1")
    for mod in (tjta, jjta):
        with pytest.raises(FileNotFoundError, match="moving_camera_seq"):
            mod.prepare_listing(str(root), str(root))
    got = tjta.prepare_listing(str(root), str(root),
                               exclude_moving_camera=False)
    assert got == jjta.prepare_listing(str(root), str(root),
                                       exclude_moving_camera=False)
    assert got == {"train": {"seq_1": []}}


def test_jta_extract_frames_fallback_matches_jax(tmp_path, monkeypatch):
    """Video -> half-res JPEG frames without the ffmpeg binary: the cv2
    VideoCapture fallback (reference jta.py:11-60) writes JAX's files."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    os.makedirs(tmp_path / "videos" / "train")
    vw = cv2.VideoWriter(str(tmp_path / "videos" / "train" / "seq_1.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    if not vw.isOpened():
        pytest.skip("no mp4 encoder in this cv2 build")
    rng = np.random.default_rng(0)
    for _ in range(5):
        vw.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
    vw.release()

    outs = {}
    for name, mod in (("port", tjta), ("jax", jjta)):
        outs[name] = tmp_path / f"out_{name}"
        mod.extract_frames(str(tmp_path), str(outs[name]))
    files = _tree_files(outs["port"], "images_half")
    assert files == _tree_files(outs["jax"], "images_half")
    assert files == [f"train/seq_1/{i:03d}.jpg" for i in range(5)]
    for f in files:
        got = np.asarray(Image.open(outs["port"] / "images_half" / f))
        want = np.asarray(Image.open(outs["jax"] / "images_half" / f))
        assert got.shape == (24, 32, 3)
        np.testing.assert_array_equal(got, want)
