"""CMU-Panoptic source for HybridDataset: the port's own copy of
``snipper_tpu/data/panoptic.py``.

Counterpart of reference ``get_panoptic`` (``hybrid_dataloader.py:1212-1390``)
and its sample listing (``:1572-1621`` train, ``:1726-1783`` eval): no
augmentation, images already at the input resolution; 3D studio poses are
rotated into the selected HD camera, scaled to mm, projected with the
distortion model, and depth-normalized.

Protocols (reference ``:1577-1620``):
- protocol 1: fixed cams (3, 12, 23); the six haggling_b sequences are test
- protocol 2: all cams except 16/30 train; 16/30 test
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from snipper_tpu_torch.data.camera import project
from snipper_tpu_torch.data.skeleton import NUM_JOINTS
from snipper_tpu_torch.data.snippet import build_trajectories

PROTOCOL1_TEST_SEQS = [
    "170221_haggling_b1", "170221_haggling_b2", "170221_haggling_b3",
    "170228_haggling_b1", "170228_haggling_b2", "170228_haggling_b3",
]
PROTOCOL1_CAMS = (3, 12, 23)
PROTOCOL2_TEST_CAMS = (16, 30)


def list_panoptic(panoptic_dir: str, protocol: int, mode: str, seq_l: int,
                  future_seq_l: int, min_gap: int, max_gap: int
                  ) -> Tuple[Dict, List[tuple]]:
    fname = os.path.join(panoptic_dir,
                         f"panoptic_all_ann_files_protocol{protocol}.pkl")
    with open(fname, "rb") as f:
        data = pickle.load(f)
    t_total = seq_l + future_seq_l
    train = mode == "train"
    entries = []
    seq_g = (min_gap + max_gap) // 2
    for k, v in data.items():
        if "poses" not in k:
            continue
        seq_name = k.split("-")[0]
        if protocol == 1:
            is_test_seq = seq_name in PROTOCOL1_TEST_SEQS
            if train == is_test_seq:
                continue
            cams = PROTOCOL1_CAMS
        elif protocol == 2:
            cams = [c for c in np.asarray(v[0][-1]).tolist()
                    if (c in PROTOCOL2_TEST_CAMS) != train]
        else:
            raise ValueError(f"panoptic protocol {protocol}")

        if train:
            indices = range(len(v) - max_gap * t_total)
        else:
            step = seq_g if seq_l == 1 else (seq_l - 1) * seq_g
            indices = range(0, len(v) - (t_total + 1) * seq_g, max(step, 1))
        for cam_idx in cams:
            for index in indices:
                entries.append(("panoptic", seq_name, int(cam_idx),
                                int(v[index][0]), int(index)))
    return data, entries


def get_panoptic_sample(ds, sample) -> Dict:
    """``ds`` is the owning HybridDataset (for config/dirs/rng)."""
    _, seq_name, cam_idx, frame_idx, index = sample
    cam = ds.panoptic_data[f"{seq_name}-cam{cam_idx:02d}"]
    cam_intr = np.asarray(cam["intr"], np.float64) * 0.5
    cam_dist = np.asarray(cam["distCoef"], np.float64)

    if ds.mode == "train":
        gap = int(ds.rng.integers(ds.seq_min_gap, ds.seq_max_gap + 1))
    else:
        gap = (ds.seq_min_gap + ds.seq_max_gap) // 2

    poses_seq = ds.panoptic_data[f"{seq_name}-poses"]
    imgs, kpts_l, k3_l, ids_l, filenames, frame_indices = [], [], [], [], [], []
    for j in range(ds.t_total):
        fidx, pose, track_id, _ = poses_seq[index + j * gap]
        assert frame_idx + j * gap == fidx
        frame_indices.append(fidx)
        filenames.append(f"cam{cam_idx:02d}_{seq_name}")
        if j < ds.seq_l:
            from snipper_tpu_torch.data.datasets import _read_rgb

            path = os.path.join(ds.panoptic_dir, seq_name, "hdImgs",
                                f"hd_00_{cam_idx:02d}", f"{fidx:08d}.jpg")
            imgs.append(_read_rgb(path).astype(np.float32) / 255.0)

        if isinstance(pose, list) and not pose:
            kpts_l.append(np.zeros((0, NUM_JOINTS, 3)))
            k3_l.append(np.zeros((0, NUM_JOINTS, 3)))
            ids_l.append(np.zeros((0,), np.int64))
        else:
            pose = np.asarray(pose)
            # studio world (cm) -> camera (mm): 10 * (R @ p + t)
            p3 = 10.0 * (pose[..., 0:3] @ cam["R"].T
                         + cam["t"].reshape(1, 1, 3))
            p2 = project(p3, cam_intr, cam_dist)
            vis = (pose[..., 3:4] > 0.1).astype(np.float64)
            kpts_l.append(np.concatenate([p2[..., 0:2], vis], -1))
            k3_l.append(p3 / 1000.0)
            ids_l.append(np.asarray(track_id, np.int64))

    h, w = ds.input_shape
    # normalize pixel coords (no affine — images are at input size already)
    depths = []
    for i in range(len(kpts_l)):
        k = kpts_l[i].copy()
        if k.shape[0]:
            k[..., 0] /= w
            k[..., 1] /= h
        kpts_l[i] = k.astype(np.float32)
        d = k3_l[i][..., 2] / ds.max_depth
        depths.append(np.stack([d, np.ones_like(d)], -1))

    tgt = build_trajectories(kpts_l, ids_l, ds.seq_l, ds.cfg.max_persons,
                             extras={"depth": depths, "kpts3d": k3_l})
    tgt["bbxes"] = ds._pixel_bbxes(tgt)
    out = ds._finalize(imgs, tgt, np.zeros((2, 3), np.float32), "panoptic",
                       filenames, cam_intr=cam_intr, image_id=frame_idx,
                       frame_indices=frame_indices)
    out["targets"]["cam_dist"] = cam_dist.astype(np.float32)
    out["targets"]["seq_name"] = seq_name
    out["targets"]["cam_idx"] = cam_idx
    return out
