"""Snippet assembly: per-frame annotations -> padded trajectory targets, and
the collation of samples into a batch. The port's own copy of
``snipper_tpu/data/snippet.py``.

Re-implements the trajectory bookkeeping every reference dataset getter
repeats inline (e.g. ``datasets/hybrid_dataloader.py:206-256`` for
PoseTrack, ``:1030-1072`` for JTA): apply the snippet-wide flip/affine to
keypoints and normalize, build one-hot frame-existence ``track_ids``, drop
future-frame persons unseen in the observed frames, compact to existing
trajectories — then (new here) pad to ``max_persons`` with a validity mask
so targets have static shapes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from snipper_tpu_torch.data.skeleton import FLIP_JOINTS
from snipper_tpu_torch.data.transforms import apply_affine_to_kpts


def transform_frame_kpts(
    kpts: np.ndarray,            # [n, K, 3] pixel (x, y, vis)
    do_flip: bool,
    img_width: float,
    trans: np.ndarray,           # 2x3 affine
    input_shape: Tuple[int, int],  # (h, w)
) -> np.ndarray:
    """Flip + affine + normalize one frame's keypoints (reference per-frame
    step 3, e.g. ``hybrid_dataloader.py:182-199``)."""
    h, w = input_shape
    k = np.asarray(kpts, np.float64).reshape(-1, kpts.shape[-2], 3).copy()
    if k.shape[0]:
        if do_flip:
            k[..., 0] = img_width - k[..., 0] - 1
            k = k[:, FLIP_JOINTS, :]
        k[..., 0:2] = apply_affine_to_kpts(k[..., 0:2], trans)
        k[..., 0] /= w
        k[..., 1] /= h
    return k.astype(np.float32)


def bbox_2d_padded_batch(kpts2d: np.ndarray, h_inc=0.15, w_inc=0.15):
    """Padded boxes from pixel-space per-person keypoints [n, K, 3] ->
    [n, 4] (reference ``HybridData.bbox_2d_padded``,
    ``hybrid_dataloader.py:1375-1410``: 15% pad on BOTH axes; a person
    with no visible joints gets the [1, 1, 1, 1] placeholder box)."""
    n = kpts2d.shape[0]
    out = np.zeros((n, 4), np.float32)
    for i in range(n):
        vis = kpts2d[i, :, 2] > 0
        if not vis.any():
            out[i] = [1.0, 1.0, 1.0, 1.0]
            continue
        kp = kpts2d[i, vis, 0:2]
        mn, mx = kp.min(0), kp.max(0)
        w, h = mx - mn
        mn -= np.array([w * w_inc / 2, h * h_inc / 2])
        out[i] = [mn[0], mn[1], w * (1 + w_inc), h * (1 + h_inc)]
    return out


def build_trajectories(
    kpts_list: Sequence[np.ndarray],      # T1 x [n_t, K, 3] normalized
    ids_list: Sequence[np.ndarray],       # T1 x [n_t] int
    seq_len: int,
    max_persons: int,
    num_joints: int = 15,
    extras: Optional[Dict[str, Sequence[np.ndarray]]] = None,
) -> Dict[str, np.ndarray]:
    """One-hot trajectory assembly + future filtering + padding.

    ``extras``: name -> per-frame list of [n_t, ...] arrays carried along
    (depth [n,K,2], bbxes [n,4], kpts3d [n,K,3], bbxes_head [n,4], ...).

    Returns dict with kpts2d [M, T1, K, 3], track_ids [M, T1],
    traj_ids [M], valid [M], n_persons, and one [M, T1, ...] entry per extra
    (depth always present, zeros if not given).
    """
    T1 = len(kpts_list)
    extras = dict(extras or {})
    kpts_list = [np.asarray(k, np.float32).reshape(-1, num_joints, 3)
                 for k in kpts_list]
    ids_list = [np.asarray(i, np.int64).reshape(-1) for i in ids_list]

    observed = set(np.concatenate(ids_list[:seq_len]).tolist()) \
        if seq_len else set()
    max_id = max(observed) if observed else -1

    # drop future-only persons (reference :213-218)
    for t in range(seq_len, T1):
        keep = np.array([pid in observed for pid in ids_list[t]], bool)
        kpts_list[t] = kpts_list[t][keep]
        ids_list[t] = ids_list[t][keep]
        for name in extras:
            lst = list(extras[name])
            lst[t] = np.asarray(lst[t])[keep]
            extras[name] = lst

    n_slots = max_id + 1
    kpts = np.zeros((n_slots, T1, num_joints, 3), np.float32)
    track = np.zeros((n_slots, T1), np.int32)
    extra_out = {}
    for name, lst in extras.items():
        proto = np.asarray(lst[0])
        extra_out[name] = np.zeros((n_slots, T1) + proto.shape[1:],
                                   np.float32)
    for t in range(T1):
        ids = ids_list[t]
        track[ids, t] = 1
        kpts[ids, t] = kpts_list[t]
        for name, lst in extras.items():
            if len(ids):
                extra_out[name][ids, t] = np.asarray(lst[t], np.float32)

    exists = track.sum(1) > 0
    traj_ids = np.where(exists)[0]
    kpts, track = kpts[exists], track[exists]
    extra_out = {k: v[exists] for k, v in extra_out.items()}

    n = kpts.shape[0]
    if n > max_persons:
        order = np.argsort(-track.sum(1))[:max_persons]
        kpts, track = kpts[order], track[order]
        extra_out = {k: v[order] for k, v in extra_out.items()}
        traj_ids = traj_ids[order]
        n = max_persons

    def pad(a):
        out = np.zeros((max_persons,) + a.shape[1:], a.dtype)
        out[:n] = a[:n]
        return out

    valid = np.zeros((max_persons,), bool)
    valid[:n] = True
    out = {
        "kpts2d": pad(kpts),
        "track_ids": pad(track),
        "traj_ids": pad(traj_ids.astype(np.int32)),
        "valid": valid,
        "n_persons": n,
    }
    for name, v in extra_out.items():
        out[name] = pad(v)
    if "depth" not in out:
        out["depth"] = np.zeros((max_persons, T1, num_joints, 2), np.float32)
    return out


def stack_batch(samples: List[Dict]) -> Dict:
    """Collate host samples into a batch dict of stacked numpy arrays (the
    step's inputs); per-sample target dicts stay a list under ``meta``.

    Device-preprocess samples carry ``raw_images [T, H, W, 3]`` uint8 with
    per-sample source sizes: they are zero-padded to the batch max rounded
    up to 128-multiples (a bounded set of shapes for the caching
    allocator; zero padding is the device warp's zero border,
    ``device_preprocess.py::warp_train_batch_device``)."""
    out = {
        "targets": {
            k: np.stack([s["targets"][k] for s in samples])
            for k in ("kpts2d", "depth", "valid")
        },
        "meta": [s["targets"] for s in samples],
    }
    if "raw_images" in samples[0]:
        pad_h = max(s["raw_images"].shape[1] for s in samples)
        pad_w = max(s["raw_images"].shape[2] for s in samples)
        pad_h = -(-pad_h // 128) * 128
        pad_w = -(-pad_w // 128) * 128
        raws = []
        for s in samples:
            r = s["raw_images"]
            raws.append(np.pad(r, ((0, 0), (0, pad_h - r.shape[1]),
                                   (0, pad_w - r.shape[2]), (0, 0))))
        out["raw_images"] = np.stack(raws)
        out["warp_inv"] = np.stack([s["warp_inv"] for s in samples])
        out["color_scale"] = np.stack([s["color_scale"] for s in samples])
    else:
        out["images"] = np.stack([s["images"] for s in samples])
    return out
