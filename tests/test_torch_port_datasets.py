"""The port's real-dataset loader against the JAX package's, on the
reference-format fixtures of ``tests/test_datasets.py`` (posetrack train
and val, jta, coco), in both modes: host-warped images, and the raw record
``device_preprocess=True`` emits. The same seed must give the same sample
list, augmentation and targets: targets within 1e-6, host-warped images
within 1e-5 (the port's numpy warp against the JAX package's C++ or numpy
one, the bound JAX holds its C++ op to), raw frames bitwise, ``warp_inv``
within 1e-6. Then the trajectory helpers, the augmentation draws,
``stack_batch``'s 128-padding and ``warp_patch`` against JAX's.

The fixture writers are copies of ``tests/test_datasets.py``'s.
"""

import json
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.data import datasets as jdatasets
from snipper_tpu.data import native_ops as jnative
from snipper_tpu.data import snippet as jsnippet
from snipper_tpu.data import transforms as jtransforms
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.data import datasets as tdatasets
from snipper_tpu_torch.data import native_ops as tnative
from snipper_tpu_torch.data import snippet as tsnippet
from snipper_tpu_torch.data import transforms as ttransforms

K = 15
TOL_TARGETS = 1e-6
TOL_IMAGES = 1e-5
TOL_INV = 1e-6


# ---------------------------------------------- fixtures (JAX tests' copies)
def _save_img(path, w=128, h=96):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(
        (np.random.default_rng(0).uniform(0, 255, (h, w, 3))).astype(np.uint8)
    ).save(path)


@pytest.fixture(scope="module")
def posetrack_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("posetrack")
    n_frames = 16
    seq = []
    rng = np.random.default_rng(1)
    for i in range(n_frames):
        fn = f"images/val/000001_x/{i:06d}.jpg"
        _save_img(str(root / fn))
        kpts = rng.uniform(10, 80, (2, 18, 3))
        kpts[..., 2] = 1.0
        seq.append({
            "filename": fn,
            "kpts2d": kpts,
            "bboxes": rng.uniform(0, 50, (2, 4)),
            "track_id": np.array([0, 1]),
            "is_label": True,
        })
    for name in ("train_filled.pkl", "val.pkl"):
        with open(root / name, "wb") as f:
            pickle.dump({"000001_x": seq}, f)
    return str(root)


@pytest.fixture(scope="module")
def jta_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("jta")
    rng = np.random.default_rng(2)
    seq = "seq_0"
    n = 30
    ids = []
    for i in range(n):
        _save_img(str(root / "images_half" / "train" / seq / f"{i:03d}.jpg"),
                  w=160, h=90)
        ann = {}
        for pid in (3, 7):
            k2 = rng.uniform(20, 150, (22, 2)).tolist()
            k3 = np.concatenate(
                [rng.uniform(-2, 2, (22, 2)),
                 rng.uniform(3, 8, (22, 1))], 1).tolist()
            occ = np.zeros((22, 2)).tolist()
            ann[str(pid)] = [k2, k3, occ]
        p = root / "ann_split" / "train" / seq / f"{i:03d}.json"
        os.makedirs(p.parent, exist_ok=True)
        with open(p, "w") as f:
            json.dump(ann, f)
        ids.append(i)
    with open(root / "jta_all_ann_files_no_moving_camera.json", "w") as f:
        json.dump({"train": {seq: ids}, "test": {seq: ids}}, f)
    return str(root)


@pytest.fixture(scope="module")
def coco_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(3)
    recs = []
    for i in range(2):
        fn = f"train2017/{i:012d}.jpg"
        _save_img(str(root / fn), w=200, h=150)
        kpts = rng.uniform(10, 140, (3, 19, 3))
        kpts[..., 2] = 1.0
        recs.append({"filename": fn, "kpts2d": kpts,
                     "bboxes": rng.uniform(0, 50, (3, 4)),
                     "width": 200, "height": 150})
    with open(root / "coco_train.pkl", "wb") as f:
        pickle.dump(recs, f)
    return str(root)


# ------------------------------------------------------------ comparisons
def assert_same_value(got, want, path="", tol=TOL_TARGETS):
    """Equal structure and types; arrays within ``tol`` (0 for integers and
    booleans), strings and ints equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_same_value(got[k], want[k], f"{path}/{k}", tol)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_value(g, w, f"{path}[{i}]", tol)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, (
            path, got.shape, got.dtype, want.shape, want.dtype)
        if want.dtype.kind in "fc":
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def assert_same_sample(got, want):
    """One loader sample of the port against JAX's: targets within 1e-6,
    host-warped images within 1e-5, raw frames bitwise, ``warp_inv``
    within 1e-6, the color scale equal."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    assert_same_value(got["targets"], want["targets"], "targets")
    if "images" in want:
        assert_same_value(got["images"], want["images"], "images",
                          TOL_IMAGES)
    else:
        assert got["raw_images"].dtype == np.uint8
        np.testing.assert_array_equal(got["raw_images"], want["raw_images"])
        assert_same_value(got["warp_inv"], want["warp_inv"], "warp_inv",
                          TOL_INV)
        assert_same_value(got["color_scale"], want["color_scale"],
                          "color_scale", 0.0)


def loader_pair(mode, seed=0, device_preprocess=False, cfg=None, **dirs):
    """The port's and JAX's ``HybridDataset`` at the tiny config (with the
    ``cfg`` fields replaced) over the same directories."""
    kw = dict(mode=mode, seed=seed, device_preprocess=device_preprocess,
              **dirs)
    cfg = cfg or {}
    return (tdatasets.HybridDataset(Config.tiny().replace(**cfg), **kw),
            jdatasets.HybridDataset(JaxConfig.tiny().replace(**cfg), **kw))


# at most this many samples of a listing are drawn (each draws and warps)
MAX_SAMPLES = 6


@pytest.mark.parametrize("device_preprocess", [False, True],
                         ids=["host_warp", "raw"])
@pytest.mark.parametrize("source,mode,epoch", [
    ("posetrack", "train", 0), ("posetrack", "val", 0),
    ("jta", "train", 1), ("coco", "train", 2)])
def test_loader_matches_jax(source, mode, epoch, device_preprocess,
                            posetrack_fixture, jta_fixture, coco_fixture):
    root = {"posetrack": posetrack_fixture, "jta": jta_fixture,
            "coco": coco_fixture}[source]
    got, want = loader_pair(mode, seed=7,
                            device_preprocess=device_preprocess,
                            **{f"{source}_dir": root})
    assert got.samples == want.samples and len(want) > 0
    for ds in (got, want):
        ds.set_epoch(epoch)
    idx = np.linspace(0, len(want) - 1, min(len(want), MAX_SAMPLES))
    for i in sorted({int(round(x)) for x in idx}):
        assert_same_sample(got[i], want[i])
    # a sample is built anew on each visit and never shared
    a, b = got[0], got[0]
    assert a["targets"] is not b["targets"]
    assert_same_sample(a, b)


def test_loader_threads_match_jax(posetrack_fixture):
    """The loaders over both datasets with two decode threads give the
    same batches: the per-sample generators live in thread-local storage
    and are derived from (seed, epoch, index), not from the thread."""
    from snipper_tpu.data.loader import DataLoader as JaxLoader
    from snipper_tpu_torch.data.loader import DataLoader

    got_ds, want_ds = loader_pair("train", seed=3,
                                  posetrack_dir=posetrack_fixture)
    kw = dict(shuffle=True, seed=5, process_index=0, process_count=1,
              num_workers=2)
    loaders = (DataLoader(got_ds, 2, **kw), JaxLoader(want_ds, 2, **kw))
    for loader in loaders:
        loader.set_epoch(1)
    pairs = list(zip(*loaders))
    assert len(pairs) == len(loaders[1]) > 0
    for g, w in pairs[:3]:
        np.testing.assert_allclose(g["images"], w["images"], rtol=0,
                                   atol=TOL_IMAGES)
        for k in ("kpts2d", "depth", "valid"):
            np.testing.assert_allclose(g["targets"][k], w["targets"][k],
                                       rtol=0, atol=TOL_TARGETS)
        assert [m["frame_indices"] for m in g["meta"]] == \
            [m["frame_indices"] for m in w["meta"]]


# ------------------------------------------------------ trajectory helpers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_helpers_match_jax(seed):
    """``transform_frame_kpts`` (with and without flip),
    ``bbox_2d_padded_batch`` (with an invisible person) and
    ``build_trajectories`` (future-only persons dropped, more persons than
    slots, extras) against JAX's on random frames."""
    rng = np.random.default_rng(seed)
    T1, seq_len, max_persons = 4, 3, 3
    trans = jtransforms.gen_trans_from_patch(
        60.0, 45.0, 120.0, 90.0, 96, 64, float(rng.uniform(-25, 25)))
    kpts, ids, depth, boxes = [], [], [], []
    for t in range(T1):
        n = int(rng.integers(0, 5))
        k = rng.uniform(0, 120, (n, K, 3))
        k[..., 2] = rng.random((n, K)) > 0.3
        if n:
            k[0, :, 2] = 0.0 if t == 1 else k[0, :, 2]
        pid = rng.choice(6, n, replace=False)
        for do_flip in (False, True):
            got = tsnippet.transform_frame_kpts(k, do_flip, 120, trans,
                                                (64, 96))
            want = jsnippet.transform_frame_kpts(k, do_flip, 120, trans,
                                                 (64, 96))
            assert_same_value(got, want, "transform_frame_kpts", 0.0)
        assert_same_value(tsnippet.bbox_2d_padded_batch(k),
                          jsnippet.bbox_2d_padded_batch(k), "bbox", 0.0)
        kpts.append(want)
        ids.append(pid)
        depth.append(rng.uniform(0, 1, (n, K, 2)))
        boxes.append(jsnippet.bbox_2d_padded_batch(k))
    extras = {"depth": depth, "bbxes": boxes}
    got = tsnippet.build_trajectories(kpts, ids, seq_len, max_persons,
                                      extras=extras)
    want = jsnippet.build_trajectories(kpts, ids, seq_len, max_persons,
                                       extras=extras)
    assert_same_value(got, want, "build_trajectories", 0.0)


def test_stack_batch_pads_raw_frames_to_128():
    """Raw frames of two sizes pad with zeros to the batch's largest
    height and width rounded up to 128-multiples, as JAX's."""
    rng = np.random.default_rng(4)
    samples = []
    for h, w in ((90, 120), (130, 260)):
        tgt = {"kpts2d": rng.random((2, 3, K, 3)).astype(np.float32),
               "depth": rng.random((2, 3, K, 2)).astype(np.float32),
               "valid": np.array([True, False])}
        samples.append({
            "raw_images": rng.integers(0, 256, (2, h, w, 3), np.uint8),
            "warp_inv": rng.random((2, 2, 3)).astype(np.float32),
            "color_scale": rng.random(3).astype(np.float32),
            "targets": tgt})
    got = tsnippet.stack_batch(samples)
    want = jsnippet.stack_batch(samples)
    assert got["raw_images"].shape == (2, 2, 256, 384, 3)
    assert not got["raw_images"][0, :, 90:].any()
    assert not got["raw_images"][0, :, :, 120:].any()
    np.testing.assert_array_equal(got["raw_images"][1, :, :130, :260],
                                  samples[1]["raw_images"])
    assert set(got) == set(want) == {"raw_images", "warp_inv",
                                     "color_scale", "targets", "meta"}
    for k in ("raw_images", "warp_inv", "color_scale"):
        np.testing.assert_array_equal(got[k], want[k])
    assert_same_value(got["targets"], want["targets"], "targets", 0.0)


# ------------------------------------------------- augmentation and warps
@pytest.mark.parametrize("augment", [True, False])
def test_aug_configs_draw_as_jax(augment):
    """``get_aug_config`` and ``get_aug_config_coco`` draw the same numbers
    in the same order from one Generator: equal outputs, and the two
    generators end in the same state."""
    for seed in range(8):
        g, w = np.random.default_rng(seed), np.random.default_rng(seed)
        for img_shape in ((128, 96), (1920, 1080)):
            got = ttransforms.get_aug_config(img_shape, (64, 96), augment, g)
            want = jtransforms.get_aug_config(img_shape, (64, 96), augment,
                                              w)
            assert_same_value(list(got), list(want), "aug", 0.0)
            got = ttransforms.get_aug_config_coco(img_shape, (64, 96), 3,
                                                  augment, g)
            want = jtransforms.get_aug_config_coco(img_shape, (64, 96), 3,
                                                   augment, w)
            assert_same_value(list(got), list(want), "aug_coco", 0.0)
        assert g.random() == w.random()


def test_affine_helpers_match_jax():
    rng = np.random.default_rng(6)
    for rot in (0.0, 17.0, -25.0):
        trans = jtransforms.gen_trans_from_patch(100.0, 80.0, 210.0, 140.0,
                                                 96, 64, rot)
        for do_flip in (False, True):
            np.testing.assert_array_equal(
                ttransforms.fold_flip_inverse(trans, do_flip, 200),
                jtransforms.fold_flip_inverse(trans, do_flip, 200))
        pts = rng.uniform(0, 200, (2, 5, 3))
        np.testing.assert_array_equal(ttransforms.trans_point2d(pts, trans),
                                      jtransforms.trans_point2d(pts, trans))
        k = rng.uniform(0, 200, (4, K, 2))
        np.testing.assert_array_equal(
            ttransforms.apply_affine_to_kpts(k, trans),
            jtransforms.apply_affine_to_kpts(k, trans))


# the four cases of tests/test_device_preprocess.py:137-143
WARP_CASES = [(0.0, False, (1.0, 1.0, 1.0)),
              (17.0, False, (0.9, 1.1, 1.05)),
              (-25.0, True, (1.2, 0.8, 1.0)),
              (8.0, True, (1.0, 1.3, 0.7))]


@pytest.mark.parametrize("rot,do_flip,color", WARP_CASES)
def test_warp_patch_matches_jax(rot, do_flip, color):
    """The port's numpy ``warp_patch`` against the JAX package's (its C++
    op where built, else the same numpy) within 1e-5."""
    rng = np.random.default_rng(int(abs(rot)) + 3)
    H, W, out_h, out_w = 40, 56, 32, 48
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    scale = max(W / out_w, H / out_h) * rng.uniform(0.8, 1.2)
    trans = jtransforms.gen_trans_from_patch(
        W * rng.uniform(0.4, 0.6), H * rng.uniform(0.4, 0.6), out_w * scale,
        out_h * scale, out_w, out_h, rot)
    got = tnative.warp_patch(img, trans, (out_h, out_w), do_flip, color)
    want = jnative.warp_patch(img, trans, (out_h, out_w), do_flip, color)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_IMAGES)
