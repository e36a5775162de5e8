"""CMU-Panoptic preprocessing -> panoptic_all_ann_files_protocol{1,2}.pkl.

The port's own copy of ``snipper_tpu/data/preprocess/cmu_panoptic.py``.

Counterpart of reference ``datasets/data_preprocess/cmu_panoptic.py``:
- ``extract_frames``: HD videos -> half-res JPEG frames (ffmpeg, cv2-free;
  reference ``:121-214``)
- ``prepare_protocol1/2``: parse camera calibrations (K -> (fx, fy, cx, cy),
  distCoef, R, t) and the hdPose3d_stage1[_coco19] skeletons; CMU COCO19
  joints are mapped to JOINT15 via the reference JOINTIDX
  (``cmu_panoptic.py:423-567``). Per-sequence records are
  ``[frame_idx, poses [n, 15, 4] (xyz cm + confidence), track_ids, cams]``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess

import numpy as np

# CMU COCO19 -> JOINT15 (reference cmu_panoptic.py:462)
PANOPTIC_TO_JOINT15 = [2, 1, 0, 3, 9, 4, 10, 5, 11, 6, 12, 7, 13, 8, 14]


def _load_cameras(data_dir: str, seq: str):
    with open(os.path.join(data_dir, seq, f"calibration_{seq}.json")) as f:
        calib = json.load(f)
    cams = {}
    for cam in calib["cameras"]:
        cam["intr"] = np.array([cam["K"][0][0], cam["K"][1][1],
                                cam["K"][0][2], cam["K"][1][2]])
        cam["distCoef"] = np.asarray(cam["distCoef"])
        cam["R"] = np.asarray(cam["R"])
        cam["t"] = np.asarray(cam["t"]).reshape(3, 1)
        cams[(cam["panel"], cam["node"])] = cam
    return cams


def _load_poses(ann_dir: str):
    records = []
    for ann in sorted(os.listdir(ann_dir)):
        frame_idx = int(ann.split("_")[-1].split(".")[0])
        with open(os.path.join(ann_dir, ann)) as f:
            bframe = json.load(f)
        poses, track_ids = [], []
        for body in bframe.get("bodies", []):
            skel = np.asarray(body["joints19"], np.float64).reshape(-1, 4)
            pose = skel[PANOPTIC_TO_JOINT15]
            poses.append(pose)
            track_ids.append(body["id"])
        if poses:
            poses = np.stack(poses)
            track_ids = np.asarray(track_ids)
        records.append([frame_idx, poses, track_ids, None])
    return records


def prepare(data_dir: str, protocol: int = 1, all_cams=(3, 12, 23)):
    pose_dir_name = ("hdPose3d_stage1_coco19" if protocol == 1
                     else "hdPose3d_stage1")
    all_files = {}
    for seq in sorted(os.listdir(data_dir)):
        if ".pkl" in seq or not os.path.isdir(os.path.join(data_dir, seq)):
            continue
        ann_dir = os.path.join(data_dir, seq, pose_dir_name)
        if not os.path.isdir(ann_dir):
            continue
        cams = _load_cameras(data_dir, seq)
        if protocol == 2:
            all_cams = sorted(n for p, n in cams if p == 0)
        for cam_idx in all_cams:
            all_files[f"{seq}-cam{cam_idx:02d}"] = cams[(0, cam_idx)]
        records = _load_poses(ann_dir)
        for r in records:
            r[3] = np.asarray(all_cams)
        all_files[f"{seq}-poses"] = records
        print(f"{seq}: {len(records)} frames, cams {list(all_cams)}")

    out_file = os.path.join(data_dir,
                            f"panoptic_all_ann_files_protocol{protocol}.pkl")
    with open(out_file, "wb") as f:
        pickle.dump(all_files, f)
    print(f"saved {out_file}")
    return all_files


def extract_frames(data_dir: str, half_res: bool = True):
    for seq in sorted(os.listdir(data_dir)):
        vid_dir = os.path.join(data_dir, seq, "hdVideos")
        if not os.path.isdir(vid_dir):
            continue
        for video in sorted(os.listdir(vid_dir)):
            out = os.path.join(data_dir, seq, "hdImgs", video.split(".")[0])
            os.makedirs(out, exist_ok=True)
            vf = "scale=iw/2:ih/2" if half_res else "null"
            subprocess.run(
                ["ffmpeg", "-y", "-i", os.path.join(vid_dir, video),
                 "-vf", vf, "-q:v", "2", "-start_number", "0",
                 os.path.join(out, "%08d.jpg")], check=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser("cmu panoptic preprocessing")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--protocol", type=int, default=1)
    p.add_argument("--skip_frames", action="store_true")
    args = p.parse_args()
    if not args.skip_frames:
        extract_frames(args.data_dir)
    prepare(args.data_dir, args.protocol)
