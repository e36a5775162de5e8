"""3D / 2D pose evaluation metrics (numpy, host-side).

The port's own copy of ``snipper_tpu/eval/metrics.py``; the assignment in
``matcher_pose3d`` is ``data/native_ops.py::lsa_pairs``, as in the JAX
package.
Counterpart of reference ``eval_utils.py``:
- ``eval_pose3d``      — per-frame greedy-LSA match in 3D then MPJPE
                         accumulation (reference ``eval_utils.py:5-67``)
- ``matcher_pose3d``   — LSA on a root-weighted 3D pose cost (``:70-93``)
- ``compute_mpjpe``    — ``mpjpe_root`` / ``mpjpe_joint`` /
                         ``pel_mpjpe_joint`` (root-aligned) (``:186-218``)
- ``unproject``        — pinhole lift (``:221-227``)
- ``eval_kpts2d_pckh`` — PCKh with 0.5 * head-size threshold (``:96-175``)

3DPCK_rel = mean(pel_mpjpe_joint < 0.15 m), as aggregated in the reference
engine (``engine.py:189-194``).

Note on ``matcher_eps``: the reference writes ``eps = 10-6`` (the integer 4,
an obvious typo for ``10e-6``) in ``matcher_pose3d`` (``eval_utils.py:75``).
The default here reproduces the reference constant so shipped-checkpoint
metrics match exactly; pass ``matcher_eps=1e-6`` for the intended behavior.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from snipper_tpu_torch.data.native_ops import lsa_pairs

POSE3D_DATASETS = ("mupots", "jta", "panoptic", "synthetic")


def transform_pts(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to ``[..., 2]`` points."""
    ones = np.ones_like(pts[..., 0:1])
    return np.concatenate([pts, ones], -1) @ np.asarray(trans).T


def unproject(kpts2d: np.ndarray, depth: np.ndarray,
              cam_intr: Sequence[float]) -> np.ndarray:
    """Pinhole unprojection: pixel (u, v) + metric depth -> camera xyz."""
    fx, fy, cx, cy = np.asarray(cam_intr, np.float64)[:4]
    z = depth[..., 0]
    x = (kpts2d[..., 0] - cx) / fx * z
    y = (kpts2d[..., 1] - cy) / fy * z
    return np.stack([x, y, z], -1)


def matcher_pose3d(gt_pose3d: np.ndarray, gt_vis: np.ndarray,
                   pred_pose3d: np.ndarray, cost_joint: float = 1.0,
                   cost_root: float = 5.0, matcher_eps: float = 10 - 6):
    """Greedy-optimal LSA between predicted and GT 3D poses."""
    gt = gt_pose3d[None]              # [1, m, K, 3]
    vis = gt_vis[None]                # [1, m, K, 1]
    pred = pred_pose3d[:, None]       # [n, 1, K, 3]
    d = np.sqrt(((vis * (gt - pred)) ** 2).sum(-1))  # [n, m, K]
    d[:, :, :1] *= cost_root
    d[:, :, 1:] *= cost_joint
    cost = d.sum(-1) / (vis.sum((-1, -2)) + matcher_eps)
    src, tgt = lsa_pairs(cost)
    return np.asarray(src, np.int64), np.asarray(tgt, np.int64)


def compute_mpjpe(gt_pose3d: np.ndarray, gt_vis: np.ndarray,
                  pred_pose3d: np.ndarray, key: str) -> np.ndarray:
    """Per-joint position errors (metres), flattened over visible joints."""
    if key == "mpjpe_joint":
        dis = np.linalg.norm(pred_pose3d - gt_pose3d, axis=-1)   # [m, K]
        return dis[gt_vis[:, :, 0] > 0]
    if key == "mpjpe_root":
        valid = gt_vis[:, 0, 0] > 0
        dis = np.linalg.norm(pred_pose3d[valid, :1] - gt_pose3d[valid, :1],
                             axis=-1)
        return dis[gt_vis[valid, :1, 0] > 0]
    if key == "pel_mpjpe_joint":
        p = pred_pose3d[:, 1:] - pred_pose3d[:, :1]
        g = gt_pose3d[:, 1:] - gt_pose3d[:, :1]
        dis = np.linalg.norm(p - g, axis=-1)                     # [m, K-1]
        return dis[gt_vis[:, 1:, 0] > 0]
    raise ValueError(f"unknown mpjpe key: {key}")


def eval_pose3d(key: str, results: List[Dict], start_t: int, end_t: int,
                score_thresh: float = 0.5,
                matcher_eps: float = 10 - 6) -> np.ndarray:
    """Accumulate per-joint 3D errors over a batch of PostProcess results
    for frames ``[start_t, end_t)`` (reference ``eval_pose3d``)."""
    out = []
    for res in results:
        if res.get("dataset") not in POSE3D_DATASETS:
            continue
        pred_exists = np.asarray(res["human_score"]) > score_thresh  # [n, T]
        for t in range(start_t, end_t):
            gt_vis_sum = np.asarray(res["gt_kpts_vis"])[:, t].sum((-1, -2))
            exist_gts = (np.asarray(res["gt_track_ids"])[:, t] > 0) & \
                        (gt_vis_sum > 0)
            if exist_gts.sum() == 0:
                continue
            gt_pose3d = np.asarray(res["gt_pose3d"])[exist_gts, t]
            gt_vis = np.asarray(res["gt_kpts_vis"])[exist_gts, t]

            exist_preds = pred_exists[:, t]
            if exist_preds.sum() == 0:
                continue
            kpts = np.asarray(res["pred_kpts"])[exist_preds, t]
            kpts = transform_pts(kpts, res["inv_trans"])
            depth = np.asarray(res["pred_depth"])[exist_preds, t]
            pose3d = unproject(kpts, depth, res["cam_intr"])

            src, tgt = matcher_pose3d(gt_pose3d, gt_vis, pose3d,
                                      matcher_eps=matcher_eps)
            if len(tgt) == 0:
                continue
            out.append(compute_mpjpe(gt_pose3d[tgt], gt_vis[tgt],
                                     pose3d[src], key))
    if not out:
        return np.zeros((0,), np.float32)
    return np.concatenate(out, 0)


def eval_kpts2d_pckh(key: str, results: List[Dict], start_t: int,
                     end_t: int) -> np.ndarray | None:
    """PCKh on PoseTrack-style results using the criterion's match indices
    (reference ``eval_kpts2d_pckh``). ``key``: pckh_root | pckh_joint."""
    assert key in ("pckh_root", "pckh_joint")
    acc = []
    for res in results:
        if res.get("dataset") != "posetrack":
            continue
        gt_track_ids = np.asarray(res["gt_track_ids"])
        if np.asarray(res["gt_traj_ids"]).shape[0] == 0:
            continue
        src_idx, tgt_idx = (np.asarray(x) for x in res["indices"])
        inv_trans = res["inv_trans"]
        for t in range(start_t, end_t):
            vis_sum = np.asarray(res["gt_kpts_vis"])[:, t].sum((-1, -2))
            exist = (gt_track_ids[:, t] > 0) & (vis_sum > 0)
            if exist.sum() == 0:
                continue
            gt_k = np.asarray(res["gt_kpts"])[tgt_idx[exist], t]
            gt_v = np.asarray(res["gt_kpts_vis"])[tgt_idx[exist], t]
            heads = np.asarray(res["gt_bbxes_head"])[tgt_idx[exist], t]
            pd_k = np.asarray(res["pred_kpts"])[src_idx[exist], t]

            gt_k = transform_pts(gt_k, inv_trans)
            pd_k = transform_pts(pd_k, inv_trans)
            head_size = 0.6 * np.sqrt(heads[:, 2] ** 2 + heads[:, 3] ** 2)
            for p in range(gt_k.shape[0]):
                vis = gt_v[p, :, 0]
                err = np.linalg.norm(gt_k[p] - pd_k[p], axis=-1)
                if key == "pckh_root":
                    pck = err[:1][vis[:1] > 0] < 0.5 * head_size[p]
                else:
                    pck = err[1:][vis[1:] > 0] < 0.5 * head_size[p]
                acc.append(pck.astype(np.float32).ravel())
    if not acc:
        return None
    return np.concatenate(acc, 0)
