"""The port's 3D sources against the JAX package's, on the fixtures of
``tests/test_datasets_3d.py``: the MuCo, MuPoTS and CMU-Panoptic
(protocols 1 and 2) extractors write JAX's pickles from the same raw
input, and the loaders give JAX's samples from them (targets within 1e-6,
images within 1e-5, raw frames bitwise); the camera model's ``project``
and ``unproject`` against JAX's within 1e-6 on the realistic CMU HD
calibration.

The fixture writers are copies of ``tests/test_datasets_3d.py``'s.
"""

import json
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from snipper_tpu.data import camera as jcamera
from snipper_tpu.data.preprocess import cmu_panoptic as jpan
from snipper_tpu.data.preprocess import muco as jmuco
from snipper_tpu.data.preprocess import mupots as jmupots
from snipper_tpu_torch.data import camera as tcamera
from snipper_tpu_torch.data.preprocess import cmu_panoptic as tpan
from snipper_tpu_torch.data.preprocess import muco as tmuco
from snipper_tpu_torch.data.preprocess import mupots as tmupots
from test_torch_port_datasets import (assert_same_sample, assert_same_value,
                                      loader_pair)

TOL_CAMERA = 1e-6


def _img(path, w=160, h=120):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(abs(hash(path)) % 2 ** 31)
    Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(path)


def _muco_style_json(n_images, prefix, intrinsic=False, rng=None):
    rng = rng or np.random.default_rng(0)
    images, annotations = [], []
    for i in range(n_images):
        fn = f"{prefix}/img_{i:06d}.jpg"
        img = {"id": i, "file_name": fn, "width": 160, "height": 120}
        if intrinsic:
            img["intrinsic"] = [100.0, 100.0, 80.0, 60.0]
        images.append(img)
        for a in range(2):
            k2 = rng.uniform(10, 150, (21, 2))
            k3 = np.concatenate([rng.uniform(-500, 500, (21, 2)),
                                 rng.uniform(2000, 8000, (21, 1))], 1)
            annotations.append({
                "image_id": i, "keypoints_img": k2.tolist(),
                "keypoints_cam": k3.tolist(),
                "keypoints_vis": [1.0] * 21,
                "bbox": [10, 10, 50, 80]})
    return {"images": images, "annotations": annotations}


def _extract_both(port_fn, jax_fn, root, out_name, *args, **kw):
    """Run both extractors on ``root`` (each into its own output
    directory, which ``root``'s files are linked into), compare their
    returns and the pickles they wrote; returns the port's output dir."""
    outs = []
    for name, fn in (("port", port_fn), ("jax", jax_fn)):
        out = root.parent / f"{root.name}_{name}"
        os.makedirs(out, exist_ok=True)
        for f in os.listdir(root):
            if not (out / f).exists():
                os.symlink(root / f, out / f)
        outs.append((out, fn(str(out), str(out), *args, **kw)))
    (port_dir, got), (jax_dir, want) = outs
    assert_same_value(got, want, "return", 0.0)
    with open(port_dir / out_name, "rb") as f:
        got = pickle.load(f)
    with open(jax_dir / out_name, "rb") as f:
        want = pickle.load(f)
    assert_same_value(got, want, out_name, 0.0)
    return str(port_dir)


@pytest.mark.parametrize("device_preprocess", [False, True],
                         ids=["host_warp", "raw"])
def test_muco_extract_and_load_match_jax(tmp_path, device_preprocess):
    root = tmp_path / "muco"
    os.makedirs(root)
    data = _muco_style_json(3, "augmented_set")
    data["images"].append({"id": 3, "file_name": "unaugmented_set/x.jpg",
                           "width": 160, "height": 120})
    with open(root / "MuCo-3DHP.json", "w") as f:
        json.dump(data, f)
    for img in data["images"][:3]:
        _img(str(root / img["file_name"]))
    muco_dir = _extract_both(tmuco.extract, jmuco.extract, root,
                             "MuCo-3DHP.pkl")

    got, want = loader_pair("train", seed=4,
                            device_preprocess=device_preprocess,
                            muco_dir=muco_dir)
    assert got.samples == want.samples and len(want) == 3
    for i in range(len(want)):
        assert_same_sample(got[i], want[i])


def test_mupots_extract_track_and_load_match_jax(tmp_path):
    root = tmp_path / "mupots"
    os.makedirs(root)
    rng = np.random.default_rng(1)
    data = _muco_style_json(40, "TS1", intrinsic=True, rng=rng)
    with open(root / "MuPoTS-3D.json", "w") as f:
        json.dump(data, f)
    for img in data["images"]:
        _img(str(root / "MuPoTS-3D_images" / img["file_name"]))
    mupots_dir = _extract_both(tmupots.extract, jmupots.extract, root,
                               "MuPoTS-3D.pkl")

    got, want = loader_pair("val", muco_dir=mupots_dir)
    assert got.samples == want.samples and len(want) > 0
    for i in range(len(want)):
        assert_same_sample(got[i], want[i])


def test_mupots_track_ids_restart_per_sequence_as_jax(tmp_path):
    root = tmp_path / "mupots"
    os.makedirs(root)
    rng = np.random.default_rng(2)
    a = _muco_style_json(5, "TS1", intrinsic=True, rng=rng)
    b = _muco_style_json(5, "TS2", intrinsic=True, rng=rng)
    offset = len(a["images"])
    for img in b["images"]:
        img["id"] += offset
    for ann in b["annotations"]:
        ann["image_id"] += offset
    # a frame with nobody in it between two tracked ones
    b["annotations"] = [x for x in b["annotations"]
                        if x["image_id"] != offset + 2]
    data = {"images": a["images"] + b["images"],
            "annotations": a["annotations"] + b["annotations"]}
    with open(root / "MuPoTS-3D.json", "w") as f:
        json.dump(data, f)
    _extract_both(tmupots.extract, jmupots.extract, root, "MuPoTS-3D.pkl")


def _panoptic_p1(root, seq="170221_haggling_b1", n_frames=40):
    """The protocol-1 fixture of tests/test_datasets_3d.py."""
    os.makedirs(root / seq / "hdPose3d_stage1_coco19")
    rng = np.random.default_rng(2)
    calib = {"cameras": [
        {"panel": 0, "node": n,
         "K": [[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]],
         "distCoef": [0.01, 0.0, 0.0, 0.0, 0.0],
         "R": np.eye(3).tolist(),
         "t": [[0.0], [0.0], [300.0]]} for n in (3, 12, 23)]}
    with open(root / seq / f"calibration_{seq}.json", "w") as f:
        json.dump(calib, f)
    for i in range(n_frames):
        bodies = []
        for pid in (0, 1):
            skel = np.concatenate(
                [rng.uniform(-50, 50, (19, 2)),
                 rng.uniform(50, 150, (19, 1)),
                 np.ones((19, 1))], 1)
            bodies.append({"id": pid, "joints19": skel.reshape(-1).tolist()})
        with open(root / seq / "hdPose3d_stage1_coco19" /
                  f"body3DScene_{i:08d}.json", "w") as f:
            json.dump({"bodies": bodies}, f)
    return (3, 12, 23), (96, 64)


HD_K = [[1396.15, 0.0, 951.0], [0.0, 1392.36, 559.5], [0.0, 0.0, 1.0]]
HD_DIST = [-0.2209, 0.1892, 7.7e-4, 9.7e-4, -0.0593]
HD_INTR = np.array([1396.15, 1392.36, 951.0, 559.5])


def _panoptic_p2(root, seq="160224_haggling1", n_frames=40):
    """The protocol-2 fixture of tests/test_datasets_3d.py, with real CMU
    HD calibration magnitudes."""
    os.makedirs(root / seq / "hdPose3d_stage1")
    rng = np.random.default_rng(5)

    def rot_z(deg):
        c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
        return [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]

    cam_nodes = (5, 16, 30)
    calib = {"cameras": [
        {"panel": 0, "node": n, "K": HD_K, "distCoef": HD_DIST,
         "R": rot_z(2.0 * i), "t": [[5.0 * i], [-3.0 * i], [300.0]]}
        for i, n in enumerate(cam_nodes)]}
    with open(root / seq / f"calibration_{seq}.json", "w") as f:
        json.dump(calib, f)
    for i in range(n_frames):
        bodies = []
        for pid in (0, 1):
            skel = np.concatenate(
                [rng.uniform(-60, 60, (19, 2)),
                 rng.uniform(-40, 40, (19, 1)),
                 np.ones((19, 1))], 1)
            bodies.append({"id": pid, "joints19": skel.reshape(-1).tolist()})
        with open(root / seq / "hdPose3d_stage1" /
                  f"body3DScene_{i:08d}.json", "w") as f:
            json.dump({"bodies": bodies}, f)
    return cam_nodes, (960, 540)


@pytest.mark.parametrize("protocol,mode", [(1, "val"), (2, "val"),
                                           (2, "train")])
def test_panoptic_prepare_and_load_match_jax(tmp_path, protocol, mode):
    """``cmu_panoptic.prepare`` writes JAX's pickle (each package into a
    copy of the raw tree), and ``HybridDataset`` gives JAX's camera split
    and samples from it: images at the input resolution, keypoints
    projected with the distortion model."""
    roots = {}
    for name in ("port", "jax"):
        roots[name] = tmp_path / name
        os.makedirs(roots[name])
        cams, (w, h) = (_panoptic_p1 if protocol == 1 else _panoptic_p2)(
            roots[name])
    got = tpan.prepare(str(roots["port"]), protocol=protocol)
    want = jpan.prepare(str(roots["jax"]), protocol=protocol)
    assert_same_value(got, want, "prepare", 0.0)
    name = f"panoptic_all_ann_files_protocol{protocol}.pkl"
    with open(roots["port"] / name, "rb") as f:
        got = pickle.load(f)
    with open(roots["jax"] / name, "rb") as f:
        assert_same_value(got, pickle.load(f), name, 0.0)

    seq = next(p for p in os.listdir(roots["port"])
               if (roots["port"] / p).is_dir())
    for cam in cams:
        for i in range(40):
            _img(str(roots["port"] / seq / "hdImgs" / f"hd_00_{cam:02d}" /
                     f"{i:08d}.jpg"), w=w, h=h)
    got, want = loader_pair(mode, cfg=dict(input_width=w, input_height=h),
                            panoptic_dir=str(roots["port"]),
                            panoptic_protocol=protocol)
    assert got.samples == want.samples and len(want) > 0
    for i in (0, len(want) - 1):
        assert_same_sample(got[i], want[i])


def _hd_points(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.uniform(2000.0, 5000.0, n)
    u = rng.uniform(30, 1890, n)
    v = rng.uniform(30, 1050, n)
    x = (u - HD_INTR[2]) / HD_INTR[0] * z
    y = (v - HD_INTR[3]) / HD_INTR[1] * z
    return np.stack([x, y, z], -1)


@pytest.mark.parametrize("case", ["project", "project_simple",
                                  "unproject", "unproject_iterative",
                                  "unproject_simple"])
def test_camera_matches_jax_realistic_calib(case):
    xyz = _hd_points(seed=len(case))
    dist = np.asarray(HD_DIST)
    if case.startswith("project"):
        kw = dict(simple_mode=case.endswith("simple"))
        got = tcamera.project(xyz, HD_INTR, dist, **kw)
        want = jcamera.project(xyz, HD_INTR, dist, **kw)
    else:
        uvd = jcamera.project(xyz, HD_INTR, dist)
        kw = dict(simple_mode=case.endswith("simple"),
                  iterations=8 if case.endswith("iterative") else 0)
        got = tcamera.unproject(uvd, HD_INTR, dist, **kw)
        want = jcamera.unproject(uvd, HD_INTR, dist, **kw)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_CAMERA)
