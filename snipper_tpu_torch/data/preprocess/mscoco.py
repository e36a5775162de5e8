"""MS-COCO keypoint preprocessing -> coco_{train,val}.pkl.

The port's own copy of ``snipper_tpu/data/preprocess/mscoco.py``.

Counterpart of reference ``datasets/data_preprocess/mscoco.py``: synthesizes
root (hip midpoint) and neck (shoulder midpoint) joints from the 17 COCO
keypoints, maps through ``COCO_TO_JOINT15``, groups annotations per image
with clipped boxes (``mscoco.py:37-123``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from snipper_tpu_torch.data.skeleton import COCO_TO_JOINT15
from snipper_tpu_torch.data.preprocess.common import image_size

LHIP, RHIP = 11, 12
LSHO, RSHO = 5, 6


def extract(dataset_path: str, out_path: str, subset: str = "train"):
    json_path = os.path.join(dataset_path, "annotations",
                             f"person_keypoints_{subset}2017.json")
    with open(json_path) as f:
        data = json.load(f)
    imgs = {im["id"]: im for im in data["images"]}

    per_image = {}
    for ann in data["annotations"]:
        k = np.asarray(ann["keypoints"], np.float64).reshape(17, 3)
        k[k[:, 2] > 0, 2] = 1
        neck = (k[LSHO:LSHO + 1] + k[RSHO:RSHO + 1]) * 0.5
        neck[0, 2] = k[LSHO, 2] * k[RSHO, 2]
        root = (k[LHIP:LHIP + 1] + k[RHIP:RHIP + 1]) * 0.5
        root[0, 2] = k[LHIP, 2] * k[RHIP, 2]
        # NOTE: the stored keypoints are the 19-joint [root, neck, coco17]
        # array indexed by COCO_TO_JOINT15, exactly as the reference stores
        # them (mscoco.py:100); the loader re-applies the same (idempotent)
        # index at read time.
        k15 = np.concatenate([root, neck, k], axis=0)[COCO_TO_JOINT15]
        if k15[:, 2].sum() == 0:
            continue
        name = f"{subset}2017/{imgs[ann['image_id']]['file_name']}"
        per_image.setdefault(name, {"bboxes": [], "kpts2d": [],
                                    "image_id": ann["image_id"]})
        per_image[name]["bboxes"].append(np.asarray(ann["bbox"], np.float64))
        per_image[name]["kpts2d"].append(k15)

    records = []
    for name in sorted(per_image):
        v = per_image[name]
        h, w = image_size(os.path.join(dataset_path, name))
        b = np.stack(v["bboxes"])
        b[:, :2] = np.maximum(b[:, :2], 0)
        b[:, 2] = np.minimum(b[:, 2], w)
        b[:, 3] = np.minimum(b[:, 3], h)
        records.append({"filename": name, "width": w, "height": h,
                        "image_id": v["image_id"],
                        "bboxes": b, "kpts2d": np.stack(v["kpts2d"])})

    os.makedirs(out_path, exist_ok=True)
    out_file = os.path.join(out_path, f"coco_{subset}.pkl")
    with open(out_file, "wb") as f:
        pickle.dump(records, f)
    print(f"saved {out_file} ({len(records)} images)")
    return records


if __name__ == "__main__":
    p = argparse.ArgumentParser("coco preprocessing")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--out_path", required=True)
    p.add_argument("--subset", default="train")
    args = p.parse_args()
    extract(args.dataset_path, args.out_path, args.subset)
