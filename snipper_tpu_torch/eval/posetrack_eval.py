"""PoseTrack-style multi-person pose estimation + tracking evaluation.

Self-contained counterpart of the reference's vendored ``poseval_old``
harness (reference ``datasets/poseval_old/``: ``evaluateAP.py``,
``evaluatePCKh``, ``evaluateTracking.py`` + ``eval_helpers.assignGTmulti``)
including a CLEAR-MOT accumulator replacing ``motmetrics`` (not a
dependency):

- per-frame GT<->prediction pose assignment by PCKh greedy-best matching at
  ``dist <= 0.5 * head_size`` (``eval_helpers.py:431-650``)
- per-joint AP via VOC-style precision/recall envelope
  (``evaluateAP.py:9-36``, ``eval_helpers.VOCap``)
- per-joint MOTA/MOTP/precision/recall over sequences with persistent
  identity correspondence (``evaluateTracking.py:58-140`` semantics)

Operates on a simple per-frame array schema; adapters parse the PoseTrack18
JSON files written by ``eval/posetrack_writer.py`` and the GT annotation
JSONs. The port's own copy of ``snipper_tpu/eval/posetrack_eval.py``; its
Hungarian step is ``data/native_ops.py::lsa_pairs``, as in the JAX package.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from snipper_tpu_torch.data.native_ops import lsa_pairs

MIN_SCORE = -9999.0


@dataclass
class Frame:
    """One frame of one sequence. Keypoints ``[n, J, 3]``: (x, y, vis) for GT
    (vis>0 == annotated), (x, y, score) for predictions (nan x == absent)."""

    kpts: np.ndarray
    track_ids: np.ndarray          # [n]
    head_sizes: Optional[np.ndarray] = None  # [n], GT only
    seq: str = ""


def head_size(x1, y1, x2, y2) -> float:
    """0.6 x head bbox diagonal (reference ``getHeadSize`` and
    ``eval_utils.py:159``)."""
    return 0.6 * float(np.linalg.norm([x2 - x1, y2 - y1]))


def _nanmean(a: np.ndarray) -> float:
    """nanmean without the all-NaN RuntimeWarning (joints with no GT)."""
    a = np.asarray(a, np.float64)
    ok = ~np.isnan(a)
    return float(a[ok].mean()) if ok.any() else float("nan")


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC-style AP: area under the precision envelope."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def assign_frame(gt: Frame, pred: Frame, dist_thresh: float = 0.5):
    """Per-frame pose assignment (reference ``assignGTmulti`` body).

    Returns (scores, labels, n_gt, mot) where scores/labels are per-joint
    lists of prediction scores and TP flags, n_gt per-joint GT counts, and
    mot per-joint dicts with track ids + masked distances for CLEAR-MOT.
    """
    J = gt.kpts.shape[1] if gt.kpts.size else pred.kpts.shape[1]
    n_gt_poses = gt.kpts.shape[0]
    n_pr_poses = pred.kpts.shape[0]
    has_gt = (gt.kpts[:, :, 2] > 0) if n_gt_poses else np.zeros((0, J), bool)
    has_pr = (~np.isnan(pred.kpts[:, :, 0])) if n_pr_poses else \
        np.zeros((0, J), bool)
    score = np.where(has_pr, pred.kpts[:, :, 2] if n_pr_poses else 0,
                     MIN_SCORE)

    scores = [[] for _ in range(J)]
    labels = [[] for _ in range(J)]
    n_gt = has_gt.sum(0) if n_gt_poses else np.zeros(J, int)
    mot = {}

    if n_gt_poses and n_pr_poses:
        dist = np.full((n_pr_poses, n_gt_poses, J), np.inf)
        for g in range(n_gt_poses):
            hs = gt.head_sizes[g] if gt.head_sizes is not None else 1.0
            d = np.linalg.norm(
                pred.kpts[:, :, 0:2] - gt.kpts[g, None, :, 0:2],
                axis=-1) / max(hs, 1e-6)                 # [n_pr, J]
            both = has_pr & has_gt[g]
            dist[:, g, :] = np.where(both, d, np.inf)
        match = dist <= dist_thresh

        # PCK-based greedy pose-level assignment: each prediction keeps only
        # its best GT; each GT takes its best prediction
        pck = match.sum(2).astype(np.float64)
        denom = np.maximum(has_gt.sum(1), 1)
        pck = pck / denom[None, :]
        best_gt = np.argmax(pck, axis=1)
        keep = np.zeros_like(pck)
        keep[np.arange(n_pr_poses), best_gt] = pck[np.arange(n_pr_poses),
                                                   best_gt]
        pr_to_gt = np.argmax(keep, axis=0)
        pr_to_gt[keep.max(axis=0) == 0] = -1

        # MOT containers per joint
        for j in range(J):
            g_idx = np.where(has_gt[:, j])[0]
            p_idx = np.where(has_pr[:, j])[0]
            dm = np.full((len(g_idx), len(p_idx)), np.nan)
            for a, gi in enumerate(g_idx):
                for b, pi in enumerate(p_idx):
                    if match[pi, gi, j]:
                        dm[a, b] = dist[pi, gi, j]
            mot[j] = {"gt_ids": gt.track_ids[g_idx].tolist(),
                      "pr_ids": pred.track_ids[p_idx].tolist(),
                      "dist": dm}

        # per-GT-joint correctness for the PCKh table (reference
        # poseval_old/evaluatePCKh.py): a GT joint is correct when its
        # pose-assigned prediction lands within 0.5 * head size
        correct = np.zeros(J, np.int64)
        for g in range(n_gt_poses):
            p = int(pr_to_gt[g])
            if p >= 0:
                correct += (match[p, g] & has_gt[g]).astype(np.int64)
        mot["pckh"] = (correct, n_gt.astype(np.int64))

        matched_pr = set(pr_to_gt[pr_to_gt >= 0].tolist())
        for p in range(n_pr_poses):
            if p in matched_pr:
                g = int(np.where(pr_to_gt == p)[0][0])
                for j in range(J):
                    if has_pr[p, j]:
                        scores[j].append(score[p, j])
                        labels[j].append(bool(match[p, g, j]))
            else:
                for j in range(J):
                    if has_pr[p, j]:
                        scores[j].append(score[p, j])
                        labels[j].append(False)
    else:
        for p in range(n_pr_poses):
            for j in range(J):
                if has_pr[p, j]:
                    scores[j].append(score[p, j])
                    labels[j].append(False)
        # reference-faithful DUMMY MOT containers (assignGTmulti's
        # gt-empty/pred-empty branch, eval_helpers.py:624-637): one fake
        # GT id 0 vs one fake pred id 0 with a nan distance per joint —
        # feeding the CLEAR-MOT accumulator exactly one object, one miss
        # and one false positive per joint for such frames (the real GT
        # ids present at other joints are NOT counted). Deliberately
        # reproduced: MOTA parity against the reference harness requires
        # its event stream, quirks included.
        for j in range(J):
            mot[j] = {"gt_ids": [0], "pr_ids": [0],
                      "dist": np.full((1, 1), np.nan)}
        mot["pckh"] = (np.zeros(J, np.int64),
                       np.asarray(n_gt, np.int64))
    return scores, labels, n_gt, mot


def compute_ap(all_scores, all_labels, all_ngt) -> Dict[str, np.ndarray]:
    """Per-joint AP/precision/recall + mean (reference ``computeMetrics``)."""
    J = len(all_ngt[0])
    ap = np.full(J + 1, np.nan)
    pre = np.full(J + 1, np.nan)
    rec = np.full(J + 1, np.nan)
    for j in range(J):
        scores = np.concatenate([np.asarray(s[j], np.float64)
                                 for s in all_scores]) if all_scores else \
            np.zeros(0)
        labels = np.concatenate([np.asarray(l[j], np.float64)
                                 for l in all_labels]) if all_labels else \
            np.zeros(0)
        n_gt = sum(int(n[j]) for n in all_ngt)
        if n_gt == 0:
            continue  # NaN, excluded from the mean (reference: nan rec)
        if scores.size == 0:
            # reference computeMetrics zero-INITIALIZES the tables and
            # skips rows with no scores (evaluateAP.py:10-27): a joint
            # with GT but no predictions scores 0.0 and IS included in
            # the mean — not NaN/excluded
            ap[j] = pre[j] = rec[j] = 0.0
            continue
        order = np.argsort(-scores)
        tp = labels[order]
        fp = 1.0 - tp
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        ap[j] = voc_ap(recall, precision) * 100
        pre[j] = precision[-1] * 100
        rec[j] = recall[-1] * 100
    for arr in (ap, pre, rec):
        arr[J] = _nanmean(arr[:J])
    return {"ap": ap, "pre": pre, "rec": rec}


class MOTAccumulator:
    """Minimal CLEAR-MOT accumulator (motmetrics-compatible semantics):
    persistent correspondences, min-cost (Hungarian) matching on the masked
    distance matrix each frame; counts FN/FP/ID-switches and matched
    distances."""

    def __init__(self):
        self.last_match: Dict = {}   # gt_id -> pr_id
        self.num_gt = 0
        self.num_fp = 0
        self.num_miss = 0
        self.num_switches = 0
        self.num_matches = 0
        self.dist_sum = 0.0

    def update(self, gt_ids: List, pr_ids: List, dist: np.ndarray):
        self.num_gt += len(gt_ids)
        matched_g, matched_p = set(), set()
        pairs = {}
        # keep previous correspondences when still valid; a prediction can
        # serve at most ONE GT (two GTs can share a carried-forward pr_id
        # after occlusion gaps — first in GT order keeps it, the other goes
        # to the Hungarian step; motmetrics enforces the same uniqueness)
        for a, g in enumerate(gt_ids):
            p = self.last_match.get(g)
            if p is not None and p in pr_ids:
                b = pr_ids.index(p)
                if b not in matched_p and np.isfinite(dist[a, b]):
                    pairs[a] = b
                    matched_g.add(a)
                    matched_p.add(b)
        # Hungarian on the rest
        free_g = [a for a in range(len(gt_ids)) if a not in matched_g]
        free_p = [b for b in range(len(pr_ids)) if b not in matched_p]
        if free_g and free_p:
            sub = dist[np.ix_(free_g, free_p)]
            big = 1e6
            cost = np.where(np.isfinite(sub), sub, big)
            rows, cols = lsa_pairs(cost)
            for r, c in zip(rows, cols):
                if np.isfinite(sub[r, c]):
                    pairs[free_g[r]] = free_p[c]
        # bookkeeping
        new_match = {}
        for a, b in pairs.items():
            g, p = gt_ids[a], pr_ids[b]
            if g in self.last_match and self.last_match[g] != p:
                self.num_switches += 1
            new_match[g] = p
            self.num_matches += 1
            self.dist_sum += float(dist[a, b])
        # carry forward unmatched correspondences (motmetrics keeps them)
        for g, p in self.last_match.items():
            if g not in new_match:
                new_match[g] = p
        self.last_match = new_match
        self.num_miss += len(gt_ids) - len(pairs)
        self.num_fp += len(pr_ids) - len(pairs)

    @property
    def metrics(self) -> Dict[str, float]:
        """Final-metric arithmetic of reference ``evaluateTracking.py``
        (:152-177): num_objects==0 makes mota/rec NaN (excluded from the
        joint mean), MOTP is 0.0 — not NaN — when there are no detections
        (0.0 IS included in the joint mean), precision is NaN only when
        there are neither detections nor false positives."""
        n = self.num_gt if self.num_gt > 0 else np.nan
        tp = self.num_matches
        total_det = (tp + self.num_fp) if (tp + self.num_fp) > 0 else np.nan
        return {
            "mota": 100.0 * (1.0 - (self.num_miss + self.num_fp
                                    + self.num_switches) / n),
            "motp": 100.0 * (1.0 - (self.dist_sum / tp)) if tp else 0.0,
            "pre": 100.0 * tp / total_det,
            "rec": 100.0 * tp / n,
            "num_switches": self.num_switches,
        }


def _remove_empty_poses(f: Frame, is_gt: bool) -> Frame:
    """poseval ``removeRectsWithoutPoints`` (eval_helpers.py:355-362): a
    pose with no annotated (GT) / present (pred) joints is removed."""
    if f.kpts.shape[0] == 0:
        return f
    keep = ((f.kpts[:, :, 2] > 0).any(1) if is_gt
            else (~np.isnan(f.kpts[:, :, 0])).any(1))
    if keep.all():
        return f
    return Frame(f.kpts[keep], f.track_ids[keep],
                 f.head_sizes[keep] if f.head_sizes is not None else None,
                 f.seq)


def _drop_gt_empty(gt_frames: List[Frame], pred_frames: List[Frame]):
    """poseval ``cleanupData`` (eval_helpers.py:281-296), order included:
    (1) frames whose GT has no poses are removed together with their
    predictions; (2) THEN poses without points are removed from both GT
    and predictions — a frame whose every GT pose lacks annotated joints
    therefore survives as GT-empty and takes ``assign_frame``'s dummy-MOT
    branch, exactly as in the reference. Shared by every entry point so
    the standalone AP/PCKh/tracking APIs agree with
    evaluate_posetrack18."""
    kept = [(g, p) for g, p in zip(gt_frames, pred_frames)
            if g.kpts.shape[0] > 0]
    if not kept:
        return [], []
    gs = [_remove_empty_poses(g, True) for g, _ in kept]
    ps = [_remove_empty_poses(p, False) for _, p in kept]
    return gs, ps


def _non_final_frame_mask(frames: List[Frame]) -> List[bool]:
    """Reference ``evaluateTracking.py::computeMetrics`` drops the LAST
    frame of every sequence from the tracking accumulation
    (``imgidxs = imgidxs[:-1]``, evaluateTracking.py:69) — deliberately
    reproduced for MOTA parity. AP/PCKh are unaffected."""
    last = {}
    for i, f in enumerate(frames):
        last[f.seq] = i
    drop = set(last.values())
    return [i not in drop for i in range(len(frames))]


def _accumulate_frame(seq_accs: Dict[str, Dict[int, "MOTAccumulator"]],
                      seq: str, mot: Dict, J: int):
    per_joint = seq_accs.setdefault(
        seq, {j: MOTAccumulator() for j in range(J)})
    for j in range(J):
        m = mot.get(j)
        if m is not None:
            per_joint[j].update(m["gt_ids"], m["pr_ids"], m["dist"])


def _aggregate_tracking(seq_accs: Dict[str, Dict[int, "MOTAccumulator"]],
                        J: int) -> Dict[str, np.ndarray]:
    """Sum per-(sequence, joint) accumulators into per-joint metrics."""
    accs = {j: MOTAccumulator() for j in range(J)}
    for per_joint in seq_accs.values():
        for j in range(J):
            a, s = accs[j], per_joint[j]
            a.num_gt += s.num_gt
            a.num_fp += s.num_fp
            a.num_miss += s.num_miss
            a.num_switches += s.num_switches
            a.num_matches += s.num_matches
            a.dist_sum += s.dist_sum
    out = {}
    for key in ("mota", "motp", "pre", "rec"):
        vals = np.array([accs[j].metrics[key] for j in range(J)])
        out[key] = np.append(vals, _nanmean(vals))
    return out


def evaluate_tracking(gt_frames: List[Frame], pred_frames: List[Frame],
                      dist_thresh: float = 0.5) -> Dict[str, np.ndarray]:
    """Per-joint MOTA/MOTP across sequences (reference evaluateTracking;
    GT-empty frames dropped per the poseval cleanup protocol)."""
    gt_frames, pred_frames = _drop_gt_empty(gt_frames, pred_frames)
    J = max((f.kpts.shape[1] for f in gt_frames if f.kpts.size),
            default=15)
    seq_accs: Dict[str, Dict[int, MOTAccumulator]] = {}
    keep = _non_final_frame_mask(gt_frames)
    for g, p, k in zip(gt_frames, pred_frames, keep):
        if not k:
            continue
        _, _, _, mot = assign_frame(g, p, dist_thresh)
        _accumulate_frame(seq_accs, g.seq, mot, J)
    return _aggregate_tracking(seq_accs, J)


def evaluate_pckh(gt_frames: List[Frame], pred_frames: List[Frame],
                  dist_thresh: float = 0.5) -> Dict[str, np.ndarray]:
    """Per-joint PCKh table + mean (reference
    ``poseval_old/evaluatePCKh.py``): fraction of GT joints whose
    pose-assigned prediction falls within ``dist_thresh`` x head size."""
    gt_frames, pred_frames = _drop_gt_empty(gt_frames, pred_frames)
    J = max((f.kpts.shape[1] for f in gt_frames if f.kpts.size), default=15)
    correct = np.zeros(J, np.int64)
    total = np.zeros(J, np.int64)
    for g, p in zip(gt_frames, pred_frames):
        _, _, _, mot = assign_frame(g, p, dist_thresh)
        c, n = mot["pckh"]
        correct[:len(c)] += c
        total[:len(n)] += n
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = 100.0 * correct / np.where(total > 0, total, np.nan)
    # total row: MICRO average (total correct / total GT joints), as the
    # reference's computePCK (evaluatePCKh.py:50-64) computes it — not the
    # per-joint macro mean. Never-annotated joints are NaN here (the
    # reference would ZeroDivisionError on them).
    micro = (100.0 * correct.sum() / total.sum() if total.sum() > 0
             else np.nan)
    return {"pckh": np.append(vals, micro)}


def evaluate_ap(gt_frames: List[Frame], pred_frames: List[Frame],
                dist_thresh: float = 0.5) -> Dict[str, np.ndarray]:
    gt_frames, pred_frames = _drop_gt_empty(gt_frames, pred_frames)
    all_s, all_l, all_n = [], [], []
    for g, p in zip(gt_frames, pred_frames):
        s, l, n, _ = assign_frame(g, p, dist_thresh)
        all_s.append(s)
        all_l.append(l)
        all_n.append(n)
    return compute_ap(all_s, all_l, all_n)


# --------------------------------------------------------------------------
# PoseTrack18 JSON adapters
# --------------------------------------------------------------------------
def _frames_from_json(data: Dict, seq: str, is_gt: bool) -> Dict[int, Frame]:
    by_img: Dict[int, list] = {}
    for ann in data.get("annotations", []):
        by_img.setdefault(ann["image_id"], []).append(ann)
    frames = {}
    for img in data.get("images", []):
        img_id = img.get("id", img.get("frame_id", 0))
        anns = by_img.get(img_id, [])
        kpts, tids, heads = [], [], []
        for a in anns:
            k = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
            if is_gt:
                pass
            else:
                k[k[:, 2] <= 0, 0] = np.nan
            kpts.append(k)
            tids.append(a.get("track_id", 0))
            bh = a.get("bbox_head", [0, 0, 0, 0])
            heads.append(head_size(bh[0], bh[1], bh[0] + bh[2],
                                   bh[1] + bh[3]))
        J = kpts[0].shape[0] if kpts else 17
        frames[img_id] = Frame(
            kpts=np.stack(kpts) if kpts else np.zeros((0, J, 3)),
            track_ids=np.asarray(tids, np.int64),
            head_sizes=np.asarray(heads) if is_gt else None,
            seq=seq)
    return frames


def evaluate_posetrack18(gt_dir: str, pred_dir: str,
                         eval_pose: bool = True,
                         eval_tracking: bool = True) -> Dict:
    """Entry point mirroring reference ``evaluate_posetrack2018``
    (``poseval_old/evaluate.py:14-54``): one GT json + one prediction json
    per video in the two directories."""
    gt_frames: List[Frame] = []
    pr_frames: List[Frame] = []
    for gt_path in sorted(glob.glob(os.path.join(gt_dir, "*.json"))):
        name = os.path.basename(gt_path)
        pred_path = os.path.join(pred_dir, name)
        if not os.path.exists(pred_path):
            continue
        with open(gt_path) as f:
            gt = _frames_from_json(json.load(f), name, True)
        with open(pred_path) as f:
            pr = _frames_from_json(json.load(f), name, False)
        for img_id in sorted(gt):
            gt_frames.append(gt[img_id])
            J = gt[img_id].kpts.shape[1] if gt[img_id].kpts.size else 17
            pr_frames.append(pr.get(img_id, Frame(
                np.zeros((0, J, 3)), np.zeros(0, np.int64), seq=name)))
    out = {}
    if not (eval_pose or eval_tracking):
        return out
    # poseval cleanup protocol (GT-empty frame drop + pose cleanup,
    # eval_helpers.cleanupData :281-296) before ANY scoring — keeping
    # GT-empty frames would count every prediction there as FPs the
    # reference protocol never sees
    gt_frames, pr_frames = _drop_gt_empty(gt_frames, pr_frames)
    # ONE assignment pass serves AP, PCKh, AND tracking (the
    # O(n_pr * n_gt * J) per-frame assignment is the cost; mot carries
    # everything each table needs)
    J = max((f.kpts.shape[1] for f in gt_frames if f.kpts.size), default=15)
    all_s, all_l, all_n = [], [], []
    correct = np.zeros(J, np.int64)
    total = np.zeros(J, np.int64)
    seq_accs: Dict[str, Dict[int, MOTAccumulator]] = {}
    track_keep = _non_final_frame_mask(gt_frames)
    for g, p, k in zip(gt_frames, pr_frames, track_keep):
        s, l, n, mot = assign_frame(g, p)
        if eval_pose:
            all_s.append(s)
            all_l.append(l)
            all_n.append(n)
            c, t = mot["pckh"]
            correct[:len(c)] += c
            total[:len(t)] += t
        if eval_tracking and k:
            _accumulate_frame(seq_accs, g.seq, mot, J)
    if eval_pose:
        out["ap"] = compute_ap(all_s, all_l, all_n)
        with np.errstate(invalid="ignore", divide="ignore"):
            vals = 100.0 * correct / np.where(total > 0, total, np.nan)
        # micro-average total row, as in evaluate_pckh (computePCK parity)
        micro = (100.0 * correct.sum() / total.sum() if total.sum() > 0
                 else np.nan)
        out["pckh"] = {"pckh": np.append(vals, micro)}
    if eval_tracking:
        out["tracking"] = _aggregate_tracking(seq_accs, J)
    return out
