"""Decoding of model outputs to pixel/metric space (reference
``PostProcess``, ``models/model.py:548-615``); the port's own copy of
``snipper_tpu/infer/postprocess.py:21-117``."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def decode_predictions(logits: np.ndarray, kpts2d: np.ndarray,
                       depth: np.ndarray, max_depth: float, input_size):
    """Decode one sample's raw outputs: softmax human probability,
    ``joint = root + disp`` scaled to input pixels, ``joint_depth =
    (root + disp/max_depth) * max_depth`` in metres.

    Shapes: ``logits [n, T, 2]``, ``kpts2d [n, T, K, 3]``,
    ``depth [n, T, K, 1]``. Returns ``(human_prob [n, T], kpt_scores
    [n, T, K, 1], kpts_px [n, T, K, 2], depth_m [n, T, K, 1])``."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    human_prob = (e / e.sum(-1, keepdims=True))[..., 1]

    d = np.asarray(depth).copy()
    d[:, :, 1:] = d[:, :, 0:1] + d[:, :, 1:] / max_depth
    out_depth = max_depth * d

    score = np.asarray(kpts2d)[..., 2:3].copy()
    k2 = np.asarray(kpts2d)[..., 0:2].copy()
    k2[:, :, 1:] = k2[:, :, :1] + k2[:, :, 1:]
    k2 = k2 * np.asarray(input_size, np.float32)
    return human_prob, score, k2, out_depth


def postprocess(
    outputs: Dict[str, np.ndarray],
    targets_list: List[Dict],
    indices: Optional[np.ndarray] = None,
) -> List[Dict]:
    """Args:
      outputs: final-layer model outputs (numpy arrays).
      targets_list: per-sample host target dicts (un-padded), each carrying
        the fields the reference PostProcess forwards (kpts2d, depth, bbxes,
        track_ids, traj_ids, max_depth, input_size, inv_trans, bbxes_head,
        cam_intr, kpts3d, filenames, video_name, frame_indices, dataset,
        image_id).
      indices: ``[B, M]`` matched query per padded target slot (from the
        criterion), optional at pure inference.

    Returns: list of result dicts (reference ``:589-614`` schema).
    """
    logits = np.asarray(outputs["pred_logits"])         # [B, n, T, 2]
    kpts = np.asarray(outputs["pred_kpts2d"])           # [B, n, T, K, 3]
    depth = np.asarray(outputs["pred_depth"])           # [B, n, T, K, 1]
    B = logits.shape[0]
    results = []
    for i in range(B):
        tgt = targets_list[i]
        max_depth = float(tgt["max_depth"])
        input_size = np.asarray(tgt["input_size"], np.float32)  # (w, h)
        # number of REAL persons: targets are padded to max_persons
        # (data/snippet.py pad(), valid slots first) — forwarding padded
        # slots would emit garbage predictions downstream (the reference's
        # targets are unpadded lists, engine.py:385-441)
        if "valid" in tgt:
            m = int(np.asarray(tgt["valid"]).sum())
        elif "n_persons" in tgt:
            m = int(tgt["n_persons"])
        else:
            m = len(np.asarray(tgt["traj_ids"]))

        human_prob, score, k2, out_depth = decode_predictions(
            logits[i], kpts[i], depth[i], max_depth, input_size)

        gt_kpts2d = np.asarray(tgt["kpts2d"], np.float32)[:m]
        gt_depth = np.asarray(tgt["depth"], np.float32)[:m].copy()
        gt_depth[..., 0] *= max_depth

        res = {
            "human_score": human_prob,
            "pred_kpt_scores": score,
            "pred_kpts": k2,
            "pred_depth": out_depth,
            "gt_kpts": gt_kpts2d[..., 0:2] * input_size,
            "gt_kpts_vis": gt_kpts2d[..., 2:3],
            "gt_depth": gt_depth,
            "bbxes": np.asarray(tgt.get("bbxes", np.zeros((m, 1, 4))))[:m],
            "gt_bbxes_head": np.asarray(
                tgt.get("bbxes_head", np.zeros((m, 1, 4))))[:m],
            "gt_track_ids": np.asarray(tgt["track_ids"])[:m],
            "gt_traj_ids": np.asarray(tgt["traj_ids"])[:m],
            "inv_trans": np.asarray(tgt["inv_trans"]),
            "input_size": input_size,
            "cam_intr": np.asarray(tgt.get("cam_intr", [0])),
            "gt_pose3d": np.asarray(tgt["kpts3d"])[:m]
            if "kpts3d" in tgt else np.asarray([0]),
            "dataset": tgt.get("dataset", ""),
            "filenames": tgt.get("filenames", []),
            "video_name": tgt.get("video_name", ""),
            "frame_indices": tgt.get("frame_indices", []),
            "image_id": tgt.get("image_id", 0),
        }
        if indices is not None:
            res["indices"] = (np.asarray(indices[i][:m]), np.arange(m))
        results.append(res)
    return results
