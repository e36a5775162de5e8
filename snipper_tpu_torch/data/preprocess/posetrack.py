"""PoseTrack2018 preprocessing -> {train,val}[_filled].pkl.

The port's own copy of ``snipper_tpu/data/preprocess/posetrack.py``.

Counterpart of reference ``datasets/data_preprocess/posetrack.py``:
- ``extract``: per-video frame records with root-augmented 18-joint
  keypoints, boxes, track ids (``posetrack.py:86-154``); val keeps head
  boxes and the COCO image ``info`` needed by the result writer
  (``posetrack.py:254-361``)
- ``fillin``: insert empty records for unlabeled frame gaps
  (``posetrack.py:157-206``)

pycocotools-free: the annotation files are plain COCO-style JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from snipper_tpu_torch.data.preprocess.common import add_root_joint, image_size

LHIP, RHIP = 11, 12  # in the 17-joint PoseTrack order


def _load_video_json(path: str):
    with open(path) as f:
        data = json.load(f)
    anns_by_img = {}
    for a in data.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)
    return data, anns_by_img


def _frame_record(img, anns, images_dir, keep_head=False, keep_info=False):
    filename = img["file_name"]
    h, w = image_size(os.path.join(images_dir, filename)) \
        if images_dir else (0, 0)
    kpts2d, bbox, track_id, heads = [], [], [], []
    for ann in anns:
        if "bbox" not in ann or not len(ann.get("keypoints", [])):
            continue
        k = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        k[k[:, 2] > 0, 2] = 1
        vis = k[:, 2] > 0
        if np.any((k[vis, :2] < -100) | (k[vis, :2] > 1e4)):
            continue
        b = np.asarray([ann["bbox"][0], ann["bbox"][1],
                        ann["bbox"][0] + ann["bbox"][2],
                        ann["bbox"][1] + ann["bbox"][3]])
        if np.any((b < -100) | (b > 1e4)):
            continue
        kpts2d.append(add_root_joint(k, LHIP, RHIP))
        bbox.append(b)
        track_id.append(ann["track_id"])
        heads.append(np.asarray(ann.get("bbox_head", [0, 0, 0, 0]),
                                np.float64))
    rec = {"filename": filename, "width": w, "height": h}
    if kpts2d:
        rec.update(kpts2d=np.stack(kpts2d),
                   bboxes=np.stack(bbox).astype(np.float32),
                   track_id=np.asarray(track_id, np.int32))
        if keep_head:
            rec["bboxes_head"] = np.stack(heads).astype(np.float32)
    else:
        rec.update(kpts2d=[], bboxes=[], track_id=[])
        if keep_head:
            rec["bboxes_head"] = []
    if keep_info:
        rec["info"] = img
        rec["is_label"] = bool(kpts2d) and bool(img.get("is_labeled", True))
    return rec


def extract(dataset_path: str, out_path: str, subset: str = "train"):
    json_dir = os.path.join(dataset_path, "annotations", subset)
    os.makedirs(out_path, exist_ok=True)
    data = {}
    categories = None
    val = subset != "train"
    for fname in sorted(os.listdir(json_dir)):
        vid, anns_by_img = _load_video_json(os.path.join(json_dir, fname))
        categories = categories or vid.get("categories")
        seq = []
        for img in vid["images"]:
            if not val and not img.get("is_labeled", True):
                continue
            anns = anns_by_img.get(img["id"], [])
            if not val and not anns:
                continue
            seq.append(_frame_record(img, anns, dataset_path,
                                     keep_head=val, keep_info=val))
        data[fname] = seq
    if val:
        data["categories"] = categories
    out_file = os.path.join(out_path, f"{subset}.pkl")
    with open(out_file, "wb") as f:
        pickle.dump(data, f)
    print(f"saved {out_file}")
    return data


def fillin(out_path: str, subset: str = "train"):
    """Fill unlabeled frame-index gaps with empty records so snippet index
    arithmetic sees a dense sequence."""
    with open(os.path.join(out_path, f"{subset}.pkl"), "rb") as f:
        data = pickle.load(f)
    filled = {}
    for fn, seq in data.items():
        if fn == "categories":
            filled[fn] = seq
            continue
        prev = None
        out = []
        for datum in seq:
            cur = int(datum["filename"].split("/")[-1].split(".")[0])
            if prev is not None and cur > prev + 1:
                stem = "/".join(datum["filename"].split("/")[:-1])
                for idx in range(prev + 1, cur):
                    out.append({"filename": f"{stem}/{idx:06d}.jpg",
                                "width": datum["width"],
                                "height": datum["height"],
                                "bboxes": [], "kpts2d": [], "track_id": []})
            out.append(datum)
            prev = cur
        filled[fn] = out
    out_file = os.path.join(out_path, f"{subset}_filled.pkl")
    with open(out_file, "wb") as f:
        pickle.dump(filled, f)
    print(f"saved {out_file}")
    return filled


if __name__ == "__main__":
    p = argparse.ArgumentParser("posetrack preprocessing")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--out_path", required=True)
    args = p.parse_args()
    extract(args.dataset_path, args.out_path, "train")
    fillin(args.out_path, "train")
    extract(args.dataset_path, args.out_path, "val")
