"""MuCo-3DHP preprocessing -> MuCo-3DHP.pkl.

The port's own copy of ``snipper_tpu/data/preprocess/muco.py``.

Counterpart of reference ``datasets/data_preprocess/muco.py:50-120``:
per-image 2D/3D keypoints + visibility mapped from the MuCo 21-joint set to
JOINT15, composited ('augmented') set only.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

# MuCo 21-joint -> JOINT15 (reference muco.py:21)
MUCO_TO_JOINT15 = [1, 0, 1, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10]


def extract(dataset_path: str, out_path: str):
    with open(os.path.join(dataset_path, "MuCo-3DHP.json")) as f:
        data = json.load(f)

    out = {}
    for img in data["images"]:
        if "unaugmented_set" in img["file_name"]:
            continue
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

    for rec in out.values():
        rec["kpts2d"] = np.stack(rec["kpts2d"]) if rec["kpts2d"] else \
            np.zeros((0, 15, 3))
        rec["kpts3d"] = np.stack(rec["kpts3d"]) if rec["kpts3d"] else \
            np.zeros((0, 15, 3))
        rec["bbx"] = np.stack(rec["bbx"]) if rec["bbx"] else np.zeros((0, 4))

    os.makedirs(out_path, exist_ok=True)
    out_file = os.path.join(out_path, "MuCo-3DHP.pkl")
    with open(out_file, "wb") as f:
        pickle.dump(out, f)
    print(f"saved {out_file} ({len(out)} images)")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser("muco preprocessing")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--out_path", required=True)
    args = p.parse_args()
    extract(args.dataset_path, args.out_path)
