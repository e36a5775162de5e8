"""Video inference pipeline: snippet sampling + cross-snippet association.

The port's own copy of the host functions of
``snipper_tpu/infer/pipeline.py:30-306`` (reference ``inference_utils.py``):

- ``snippet_index``: snippet start stride ``gap * (T - 1)``, so consecutive
  snippets overlap by exactly one frame.
- ``iter_snippet_samples``: lazy decode + centre affine resize on the host,
  or decode alone for the warp on the device.
- ``associate_snippets``: greedy bidirectional-argmin identity propagation
  over the shared frame; matched poses on the overlap are score-weighted
  averaged.

Frames are decoded with PIL; cv2 is needed only for ``--video``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from snipper_tpu_torch.data.transforms import (gen_trans_from_patch,
                                               generate_patch_image)


def transform_pts_np(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    ones = np.ones_like(pts[..., 0:1])
    return np.concatenate([pts, ones], -1) @ np.asarray(trans).T


def compute_match_cost(pre: np.ndarray, cur: np.ndarray, h: float, w: float,
                       max_depth: float) -> np.ndarray:
    """Normalized squared L2 over (x, y, depth, 0.1*score) summed over
    keypoints; ``pre [m, K, 4]``, ``cur [n, K, 4]`` -> ``[m, n]``."""
    d = pre[:, None] - cur[None, :]
    d = d * np.array([1.0 / w, 1.0 / h, 1.0 / max_depth, 0.1])
    return np.sum(d ** 2, axis=(-1, -2))


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def extract_video_frames(video_path: str, out_dir: str) -> int:
    """Decode a video file into numbered JPEG frames (``%06d.jpg``), first
    clearing the image files a previous extraction left in ``out_dir``.
    Returns the frame count."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    os.makedirs(out_dir, exist_ok=True)
    for old in os.listdir(out_dir):
        if old.lower().endswith(IMAGE_EXTS):
            os.remove(os.path.join(out_dir, old))
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        path = os.path.join(out_dir, f"{i:06d}.jpg")
        if not cv2.imwrite(path, frame,
                           [int(cv2.IMWRITE_JPEG_QUALITY), 95]):
            cap.release()
            raise OSError(f"failed to write frame {i} to {path}")
        i += 1
    cap.release()
    if i == 0:
        raise ValueError(f"no frames decoded from {video_path}")
    return i


def snippet_index(data_dir: str, num_frames: int, gap: int):
    """(frame_indices, all_files): snippet start stride is ``gap * (T - 1)``
    (``gap`` when T == 1). Only image files count as frames."""
    skip = gap if num_frames == 1 else gap * (num_frames - 1)
    all_files = sorted(
        f for f in os.listdir(data_dir)
        if f.lower().endswith(IMAGE_EXTS)
        and os.path.isfile(os.path.join(data_dir, f)))
    return list(range(0, len(all_files) - skip, skip)), all_files


def iter_snippet_samples(data_dir: str, num_frames: int, gap: int,
                         input_shape: Tuple[int, int],
                         warp_on_device: bool = False,
                         index: Optional[tuple] = None):
    """Lazily decode snippet samples: dicts with ``imgs [T, H, W, 3]``
    float32 in [0, 1], ``filenames``, ``inv_trans``, ``input_size`` (w, h)
    and ``img_size`` (w, h).

    ``warp_on_device``: skip the host warp; a sample carries the decoded
    uint8 ``raw_imgs [T, H, W, 3]`` and the forward affine ``trans`` for
    :func:`snipper_tpu_torch.data.device_preprocess.preprocess_snippet_device`
    instead of ``imgs``.

    ``index``: a precomputed ``(frame_indices, all_files)`` from
    :func:`snippet_index`, the same listing the caller associates against."""
    frame_indices, all_files = (index if index is not None
                                else snippet_index(data_dir, num_frames,
                                                   gap))
    h, w = input_shape
    for idx in frame_indices:
        filenames = [all_files[idx + gap * t] for t in range(num_frames)]
        imgs = np.stack([_read_rgb(os.path.join(data_dir, f))
                         for f in filenames])
        img_h, img_w = imgs.shape[1:3]

        # centre crop-resize covering the input aspect (no augmentation)
        scale = max(img_w / w, img_h / h)
        cx, cy = img_w * 0.5, img_h * 0.5
        trans = gen_trans_from_patch(cx, cy, w * scale, h * scale, w, h, 0.0)
        inv_trans = gen_trans_from_patch(cx, cy, w * scale, h * scale, w, h,
                                         0.0, inv=True)
        sample = {
            "filenames": filenames,
            "inv_trans": inv_trans.astype(np.float32),
            "input_size": np.array([w, h], np.float32),
            "img_size": np.array([img_w, img_h], np.float32),
        }
        if warp_on_device:
            sample["raw_imgs"] = imgs.astype(np.uint8)
            sample["trans"] = trans.astype(np.float32)
        else:
            sample["imgs"] = np.stack(
                [generate_patch_image(im, False, trans, (h, w))
                 for im in imgs]).astype(np.float32)
        yield sample


def prefetched(it, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue so host
    decoding overlaps the device forward. An exception in the iterator is
    raised to the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    error: list = []

    def worker():
        try:
            for x in it:
                q.put(x)
        except BaseException as e:  # noqa: BLE001 - surfaced to consumer
            error.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        x = q.get()
        if x is sentinel:
            if error:
                raise error[0]
            return
        yield x


def associate_snippets(results: List[Dict], frame_indices: List[int],
                       all_filenames: List[str], num_frames: int, gap: int,
                       max_depth: float):
    """Stitch per-snippet detections into video-level identities.

    ``results[k]`` is a per-snippet dict with ``human_score [n, T]``,
    ``pred_kpt_scores/pred_kpts/pred_depth``, ``inv_trans``, ``img_size``,
    ``filenames`` (pixel/metric space).

    Returns ``(all_frames_results, max_pid)`` where
    ``all_frames_results[frame_idx] = (pids [m], frame_data [m, K, 4])``
    with columns (x, y, depth, score) and the root replaced by the hip
    midpoint. Runs in the host span ``serve.associate``.
    """
    with record_function("serve.associate"):
        return _associate(results, frame_indices, all_filenames, num_frames,
                          gap, max_depth)


def _associate(results, frame_indices, all_filenames, num_frames, gap,
               max_depth):
    all_frames: Dict[int, tuple] = {}
    max_pid = 0

    def frame_block(kpts, scores, depth, inv_trans):
        k = transform_pts_np(kpts, inv_trans)
        data = np.concatenate([k, depth, scores], axis=-1)  # [m, K, 4]
        if data.shape[0]:
            data[:, 0, :] = (data[:, 9, :] + data[:, 10, :]) / 2
        return data

    for s_idx, res in enumerate(results):
        pred_human = np.asarray(res["human_score"]) > 0.5      # [nq, T]
        exist = pred_human.sum(1) > 0
        pred_human = pred_human[exist]
        scores = np.asarray(res["pred_kpt_scores"])[exist]
        kpts = np.asarray(res["pred_kpts"])[exist]
        depth = np.asarray(res["pred_depth"])[exist]
        inv_trans = np.asarray(res["inv_trans"])

        cur2pre_idx = np.zeros([0], np.int64)
        if s_idx == 0:
            n = pred_human.shape[0]
            seq_pids = np.arange(n)
            max_pid += n
        else:
            frame_idx = frame_indices[s_idx]
            key = frame_idx if num_frames > 1 else frame_idx - gap
            pre_pids, pre_data = all_frames.get(key, (np.zeros(0, np.int32),
                                                      np.zeros((0, 15, 4))))
            cur_exist = pred_human[:, 0]
            cur_data = frame_block(kpts[cur_exist, 0], scores[cur_exist, 0],
                                   depth[cur_exist, 0], inv_trans)

            if cur_data.shape[0] == 0 or pre_data.shape[0] == 0:
                seq_pids = np.full(cur_exist.shape[0], -1, np.int32)
                miss = int((seq_pids == -1).sum())
                seq_pids[seq_pids == -1] = np.arange(miss) + max_pid
                max_pid += miss
            else:
                w, h = np.asarray(res["img_size"])
                cost = compute_match_cost(pre_data, cur_data, h, w, max_depth)
                # greedy bidirectional argmin: a pair matches only if each is
                # the other's nearest
                pre2cur = np.argmin(cost, axis=1)
                mask = np.full(cost.shape, np.inf)
                mask[np.arange(len(pre2cur)), pre2cur] = 1
                masked = cost * mask
                cur_no_match = (mask != np.inf).sum(0) == 0
                cur2pre_idx = np.argmin(masked, axis=0)
                cur2pre_idx[cur_no_match] = -1

                cur_pids = np.full(len(cur2pre_idx), -1, np.int32)
                for i, p in enumerate(cur2pre_idx):
                    if p == -1:
                        cur_pids[i] = max_pid
                        max_pid += 1
                    else:
                        cur_pids[i] = pre_pids[p]
                seq_pids = np.full(cur_exist.shape[0], -1, np.int32)
                seq_pids[cur_exist] = cur_pids
                miss = int((seq_pids == -1).sum())
                seq_pids[seq_pids == -1] = np.arange(miss) + max_pid
                max_pid += miss

        for t in range(num_frames):
            if res["filenames"][t] != \
                    all_filenames[frame_indices[s_idx] + t * gap]:
                raise ValueError(
                    f"snippet {s_idx} frame {t} is {res['filenames'][t]!r}, "
                    f"the index expects "
                    f"{all_filenames[frame_indices[s_idx] + t * gap]!r}")
            frame_idx = frame_indices[s_idx] + t * gap
            ex = pred_human[:, t]
            data = frame_block(kpts[ex, t], scores[ex, t], depth[ex, t],
                               inv_trans)
            # score-weighted pose averaging on the shared (overlap) frame
            if (t == 0 and s_idx > 0 and cur2pre_idx.shape[0] > 0
                    and num_frames > 1):
                key = frame_indices[s_idx]
                _, pre_data = all_frames[key]
                valid = cur2pre_idx != -1
                cur_i = np.arange(len(cur2pre_idx))[valid]
                pre_i = cur2pre_idx[valid]
                ps = pre_data[pre_i][:, :, 3:4]
                cs = data[cur_i][:, :, 3:4]
                data[cur_i, :, 3:4] = (ps + cs) / 2
                data[cur_i, :, 0:3] = (
                    ps * pre_data[pre_i][:, :, 0:3]
                    + cs * data[cur_i][:, :, 0:3]) / (ps + cs)
            all_frames[frame_idx] = (seq_pids[ex], data)
    return all_frames, max_pid
