"""MuPoTS-3D preprocessing -> MuPoTS-3D.pkl.

The port's own copy of ``snipper_tpu/data/preprocess/mupots.py``.

Counterpart of reference ``datasets/data_preprocess/mupots.py:54-160``:
per-frame 2D/3D keypoints in JOINT15, plus GT track ids built by greedy
bidirectional-argmin 3D-pose matching between consecutive frames.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from snipper_tpu_torch.data.preprocess.muco import MUCO_TO_JOINT15


def _greedy_track(pre_poses, pre_pids, cur_poses, max_pid):
    """Greedy bidirectional-argmin matching on mean per-joint 3D distance
    (the same structure as the inference association)."""
    cost = np.mean(np.sqrt(np.sum(
        (pre_poses[:, None] - cur_poses[None]) ** 2, axis=-1)), axis=-1)
    pre2cur = np.argmin(cost, axis=1)
    mask = np.full(cost.shape, np.inf)
    mask[np.arange(len(pre2cur)), pre2cur] = 1
    masked = cost * mask
    no_match = (mask != np.inf).sum(0) == 0
    cur2pre = np.argmin(masked, axis=0)
    cur2pre[no_match] = -1
    pids = np.full(len(cur2pre), -1, np.int32)
    for i, p in enumerate(cur2pre):
        if p == -1:
            pids[i] = max_pid
            max_pid += 1
        else:
            pids[i] = pre_pids[p]
    return pids, max_pid


def extract(dataset_path: str, out_path: str):
    with open(os.path.join(dataset_path, "MuPoTS-3D.json")) as f:
        data = json.load(f)

    out = {}
    for img in data["images"]:
        img["kpts2d"] = []
        img["kpts3d"] = []
        img["bbx"] = []
        out[img["id"]] = img
    for ann in data["annotations"]:
        rec = out.get(ann["image_id"])
        if rec is None:
            continue
        k2 = np.asarray(ann["keypoints_img"], np.float64)[MUCO_TO_JOINT15]
        k3 = np.asarray(ann["keypoints_cam"], np.float64)[MUCO_TO_JOINT15]
        vis = np.asarray(ann["keypoints_vis"], np.float64)[MUCO_TO_JOINT15]
        rec["kpts2d"].append(np.concatenate([k2, vis[:, None]], 1))
        rec["kpts3d"].append(k3)
        rec["bbx"].append(np.asarray(ann["bbox"], np.float64))

    # stack + track-id assignment per sequence (sequence = filename prefix)
    max_pid = 0
    prev_seq = None
    prev_poses = prev_pids = None
    for img_id in sorted(out.keys()):
        rec = out[img_id]
        rec["kpts2d"] = np.stack(rec["kpts2d"]) if rec["kpts2d"] else \
            np.zeros((0, 15, 3))
        rec["kpts3d"] = np.stack(rec["kpts3d"]) if rec["kpts3d"] else \
            np.zeros((0, 15, 3))
        rec["bbx"] = np.stack(rec["bbx"]) if rec["bbx"] else np.zeros((0, 4))
        seq = rec["file_name"].split("/")[0]
        n = rec["kpts3d"].shape[0]
        if seq != prev_seq:
            # track ids restart at 0 for every sequence (reference
            # mupots.py:109-115: max_pid = n, seq_pids = arange(n)) —
            # a global counter would also inflate build_trajectories'
            # (max_id+1)-slot arrays for late sequences
            pids = np.arange(n, dtype=np.int32)
            max_pid = n
        elif prev_poses is None or prev_poses.shape[0] == 0 or n == 0:
            pids = np.arange(max_pid, max_pid + n, dtype=np.int32)
            max_pid += n
        else:
            pids, max_pid = _greedy_track(prev_poses, prev_pids,
                                          rec["kpts3d"], max_pid)
        rec["track_ids"] = pids
        prev_seq, prev_poses, prev_pids = seq, rec["kpts3d"], pids

    os.makedirs(out_path, exist_ok=True)
    out_file = os.path.join(out_path, "MuPoTS-3D.pkl")
    with open(out_file, "wb") as f:
        pickle.dump(out, f)
    print(f"saved {out_file} ({len(out)} frames)")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser("mupots preprocessing")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--out_path", required=True)
    args = p.parse_args()
    extract(args.dataset_path, args.out_path)
