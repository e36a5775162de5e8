"""JTA (GTA-V) preprocessing: per-frame annotation split + sample listings.

The port's own copy of ``snipper_tpu/data/preprocess/jta.py``.

Counterpart of reference ``datasets/data_preprocess/jta.py``:
- ``split_annotations``: the per-sequence annotation matrix
  [frame, person, joint, x2d, y2d, x3d, y3d, z3d, occluded, self_occluded]
  is split into per-frame JSONs ``{person_id: (kpts2d[44], kpts3d[66],
  occ[44])}`` (``jta.py:146-205``); frame numbering starts at 1 in the raw
  data and 0 in the split files.
- ``prepare_listing``: index JSON of available frames per sequence; the
  fixed-camera variant excludes the 99 moving-camera sequences
  (``jta.py:234-257``, list shipped as moving_camera_seq.txt).
- video->frame extraction prefers ffmpeg, falling back to cv2
  VideoCapture (the reference's own mechanism, ``jta.py:11-60``) when the
  ffmpeg binary is absent; JTA ships 900-frame seq_*.mp4 videos.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np

# reference moving_camera_seq.txt (99 sequences with camera motion)
MOVING_CAMERA_SEQS_FILE = "moving_camera_seq.txt"


def _extract_frames_cv2(video_path: str, out: str, half_res: bool):
    """cv2 VideoCapture fallback — the reference's own mechanism
    (``jta.py:11-60``: read, resize to half, imwrite)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if half_res:
            frame = cv2.resize(frame, (frame.shape[1] // 2,
                                       frame.shape[0] // 2))
        cv2.imwrite(os.path.join(out, f"{i:03d}.jpg"), frame,
                    [int(cv2.IMWRITE_JPEG_QUALITY), 95])
        i += 1
    cap.release()
    return i


def extract_frames(data_dir: str, out_dir: str, half_res: bool = True):
    """Split seq videos into JPEG frames at half resolution: ffmpeg when
    the binary exists, else cv2 VideoCapture (reference ``jta.py:11-60``)."""
    import shutil

    have_ffmpeg = shutil.which("ffmpeg") is not None
    for subset in os.listdir(os.path.join(data_dir, "videos")):
        for video in sorted(os.listdir(os.path.join(data_dir, "videos",
                                                    subset))):
            seq = video.split(".")[0]
            out = os.path.join(out_dir, "images_half", subset, seq)
            os.makedirs(out, exist_ok=True)
            src = os.path.join(data_dir, "videos", subset, video)
            if have_ffmpeg:
                vf = "scale=iw/2:ih/2" if half_res else "null"
                subprocess.run(
                    ["ffmpeg", "-y", "-i", src,
                     "-vf", vf, "-q:v", "2", "-start_number", "0",
                     os.path.join(out, "%03d.jpg")], check=True)
            else:
                _extract_frames_cv2(src, out, half_res)


def split_annotations(data_dir: str, out_dir: str, n_frames: int = 900):
    for subset in os.listdir(os.path.join(data_dir, "annotations")):
        for ann_fname in sorted(os.listdir(
                os.path.join(data_dir, "annotations", subset))):
            if "coco" in ann_fname:
                continue
            seq = ann_fname.split(".")[0]
            out_seq = os.path.join(out_dir, "ann_split", subset, seq)
            os.makedirs(out_seq, exist_ok=True)
            with open(os.path.join(data_dir, "annotations", subset,
                                   ann_fname)) as f:
                data = np.asarray(json.load(f))
            for frame in range(n_frames):
                out_file = os.path.join(out_seq, f"{frame:03d}.json")
                if os.path.exists(out_file):
                    continue
                # raw frames are 1-based
                fd = data[data[:, 0] == frame + 1]
                frame_dict = {}
                for pid in sorted(set(fd[:, 1].astype(int).tolist())):
                    rows = fd[fd[:, 1] == pid]
                    k2 = rows[:, 3:5].reshape(-1).tolist()
                    k3 = rows[:, 5:8].reshape(-1).tolist()
                    occ = rows[:, 8:10].astype(int).reshape(-1).tolist()
                    frame_dict[int(pid)] = (k2, k3, occ)
                with open(out_file, "w") as f:
                    json.dump(frame_dict, f)


def prepare_listing(data_dir: str, out_dir: str,
                    exclude_moving_camera: bool = True,
                    moving_camera_list: str | None = None):
    """``moving_camera_list``: explicit path to the 99-sequence exclusion
    list; otherwise searched in ``data_dir`` then ``out_dir``. The listing
    is NAMED no_moving_camera, so silently proceeding without the list
    would label moving-camera-contaminated data as clean — a missing list
    is an error, not a no-op."""
    moving = set()
    if exclude_moving_camera:
        candidates = ([moving_camera_list] if moving_camera_list else
                      [os.path.join(d, MOVING_CAMERA_SEQS_FILE)
                       for d in (data_dir, out_dir)])
        path = next((p for p in candidates if p and os.path.exists(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"{MOVING_CAMERA_SEQS_FILE} not found in {candidates}: the "
                "fixed-camera JTA listing needs the 99-sequence exclusion "
                "list (shipped next to the reference's "
                "datasets/data_preprocess/jta.py; reference jta.py:234-257)."
                " Pass --moving_camera_list / moving_camera_list=, place "
                "the file in the data dir, or set "
                "exclude_moving_camera=False to index ALL sequences.")
        with open(path) as f:
            moving = {int(line.strip()) for line in f if line.strip()}
    all_files = {}
    for subset in os.listdir(os.path.join(data_dir, "ann_split")):
        listing = {}
        for seq in sorted(os.listdir(os.path.join(data_dir, "ann_split",
                                                  subset))):
            if exclude_moving_camera and int(seq.split("_")[1]) in moving:
                continue
            frames = sorted(int(f.split(".")[0]) for f in os.listdir(
                os.path.join(data_dir, "ann_split", subset, seq)))
            listing[seq] = frames
        all_files[subset] = listing
    name = ("jta_all_ann_files_no_moving_camera.json"
            if exclude_moving_camera else "jta_all_ann_files.json")
    out_file = os.path.join(out_dir, name)
    with open(out_file, "w") as f:
        json.dump(all_files, f)
    print(f"saved {out_file}")
    return all_files


if __name__ == "__main__":
    p = argparse.ArgumentParser("jta preprocessing")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--skip_frames", action="store_true")
    p.add_argument("--moving_camera_list", default=None,
                   help="path to moving_camera_seq.txt (searched in "
                        "--data_dir/--out_dir when omitted)")
    p.add_argument("--keep_moving_camera", action="store_true",
                   help="index ALL sequences (no exclusion list needed)")
    args = p.parse_args()
    if not args.skip_frames:
        extract_frames(args.data_dir, args.out_dir)
    split_annotations(args.data_dir, args.out_dir)
    # ann_split lives in out_dir; the exclusion list may sit next to the
    # RAW data, so offer that location to the search as well
    mcl = args.moving_camera_list
    if mcl is None:
        raw = os.path.join(args.data_dir, MOVING_CAMERA_SEQS_FILE)
        mcl = raw if os.path.exists(raw) else None
    prepare_listing(args.out_dir, args.out_dir,
                    exclude_moving_camera=not args.keep_moving_camera,
                    moving_camera_list=mcl)
