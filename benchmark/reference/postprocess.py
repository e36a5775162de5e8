"""The plain reference of the serving path's host side: the snippet
geometry, the input warp, the decoding of the model's outputs and the
association of persons across snippets (reference ``inference_utils.py``,
``models/model.py:548-615``).

- A video's snippets start every ``gap * (T - 1)`` frames, so consecutive
  snippets share one frame.
- A frame is centre-cropped to the input's aspect and resized to the input
  size by an inverse-mapped bilinear warp with a zero border
  (``cv2.warpAffine`` with ``INTER_LINEAR``), then divided by 255.
- A query's human probability is the softmax of its two logits; a joint is
  the root plus its displacement, in input pixels; a joint's depth is the
  root depth plus its displacement over ``max_depth``, in metres.
- Association: the persons of a snippet's first frame are matched to those
  already on that (shared) frame by a greedy bidirectional nearest
  neighbour over (x, y, depth, 0.1 score) normalised by the image size and
  ``max_depth``; the matched ones keep their identity and their poses on
  the shared frame are averaged, weighted by score; the others get new
  identities.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def snippet_starts(n_frames: int, num_frames: int, gap: int) -> List[int]:
    skip = gap if num_frames == 1 else gap * (num_frames - 1)
    return list(range(0, n_frames - skip, skip))


def _affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    a = np.concatenate([src, np.ones((3, 1))], 1)
    return np.linalg.solve(a, dst).T


def centre_affine(img_w: int, img_h: int, out_w: int, out_h: int,
                  inv: bool = False) -> np.ndarray:
    """The 2x3 affine from the image to the input (``inv``: back), centre
    crop at the input's aspect, no rotation; built from three points as
    ``cv2.getAffineTransform``, from the points' f32 coordinates."""
    scale = max(img_w / out_w, img_h / out_h)
    cx, cy = img_w * 0.5, img_h * 0.5
    sw, sh = out_w * scale, out_h * scale
    f32 = np.float32
    src = np.array([[cx, cy], [cx, cy + f32(sh * 0.5)],
                    [cx + f32(sw * 0.5), cy]], f32).astype(np.float64)
    dst = np.array([[out_w * 0.5, out_h * 0.5], [out_w * 0.5, out_h],
                    [out_w, out_h * 0.5]], f32).astype(np.float64)
    return _affine(dst, src) if inv else _affine(src, dst)


def warp(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``img [H, W, 3]`` uint8 -> ``[out_h, out_w, 3]`` f32 in [0, 1]."""
    h, w = img.shape[:2]
    m = centre_affine(w, h, out_w, out_h, inv=True)
    ys, xs = np.meshgrid(np.arange(out_h, dtype=np.float64),
                         np.arange(out_w, dtype=np.float64), indexing="ij")
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    src = img.astype(np.float64)
    out = np.zeros((out_h, out_w, img.shape[2]))
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = (x0 + dx).astype(np.int64), (y0 + dy).astype(np.int64)
            wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            out += (wgt * ok)[..., None] * src[np.clip(yi, 0, h - 1),
                                               np.clip(xi, 0, w - 1)]
    return (out / 255.0).astype(np.float32)


def decode(logits: np.ndarray, kpts2d: np.ndarray, depth: np.ndarray,
           max_depth: float, input_size) -> Tuple[np.ndarray, ...]:
    """One sample's ``(human_prob [n, T], kpt_scores [n, T, K, 1],
    kpts_px [n, T, K, 2], depth_m [n, T, K, 1])``."""
    lg = logits.astype(np.float64)
    e = np.exp(lg - lg.max(-1, keepdims=True))
    prob = (e / e.sum(-1, keepdims=True))[..., 1]
    d = depth.astype(np.float64).copy()
    d[:, :, 1:] = d[:, :, :1] + d[:, :, 1:] / max_depth
    k = kpts2d[..., 0:2].astype(np.float64).copy()
    k[:, :, 1:] = k[:, :, :1] + k[:, :, 1:]
    return (prob, kpts2d[..., 2:3].astype(np.float64),
            k * np.asarray(input_size, np.float64), max_depth * d)


def _match_cost(pre, cur, h, w, max_depth):
    d = pre[:, None] - cur[None, :]
    d = d * np.array([1.0 / w, 1.0 / h, 1.0 / max_depth, 0.1])
    return np.sum(d ** 2, axis=(-1, -2))


def _block(kpts, scores, depth, inv_trans):
    ones = np.ones_like(kpts[..., 0:1])
    k = np.concatenate([kpts, ones], -1) @ np.asarray(inv_trans).T
    data = np.concatenate([k, depth, scores], -1)
    if data.shape[0]:
        data[:, 0, :] = (data[:, 9, :] + data[:, 10, :]) / 2
    return data


def associate(results: List[Dict], starts: List[int], num_frames: int,
              gap: int, max_depth: float):
    """``({frame: (pids [m], data [m, K, 4])}, number of identities)`` over
    one video's decoded snippets ``results`` (each with ``human_score``,
    ``pred_kpt_scores``, ``pred_kpts``, ``pred_depth``, ``inv_trans``,
    ``img_size``), columns (x, y, depth, score) in image pixels, the root
    replaced by the hips' midpoint."""
    frames: Dict[int, tuple] = {}
    max_pid = 0
    for s, res in enumerate(results):
        human = np.asarray(res["human_score"]) > 0.5
        exist = human.sum(1) > 0
        human = human[exist]
        scores = np.asarray(res["pred_kpt_scores"])[exist]
        kpts = np.asarray(res["pred_kpts"])[exist]
        depth = np.asarray(res["pred_depth"])[exist]
        inv = np.asarray(res["inv_trans"])
        cur2pre = np.zeros([0], np.int64)
        if s == 0:
            pids = np.arange(human.shape[0])
            max_pid += human.shape[0]
        else:
            key = starts[s] if num_frames > 1 else starts[s] - gap
            pre_pids, pre = frames.get(key, (np.zeros(0, np.int32),
                                             np.zeros((0, 15, 4))))
            first = human[:, 0]
            cur = _block(kpts[first, 0], scores[first, 0], depth[first, 0],
                         inv)
            pids = np.full(first.shape[0], -1, np.int32)
            if cur.shape[0] and pre.shape[0]:
                w, h = np.asarray(res["img_size"])
                cost = _match_cost(pre, cur, h, w, max_depth)
                pre2cur = np.argmin(cost, 1)
                mask = np.full(cost.shape, np.inf)
                mask[np.arange(len(pre2cur)), pre2cur] = 1
                lonely = (mask != np.inf).sum(0) == 0
                cur2pre = np.argmin(cost * mask, 0)
                cur2pre[lonely] = -1
                cur_pids = np.full(len(cur2pre), -1, np.int32)
                for i, p in enumerate(cur2pre):
                    if p == -1:
                        cur_pids[i] = max_pid
                        max_pid += 1
                    else:
                        cur_pids[i] = pre_pids[p]
                pids[first] = cur_pids
            miss = int((pids == -1).sum())
            pids[pids == -1] = np.arange(miss) + max_pid
            max_pid += miss
        for t in range(num_frames):
            f = starts[s] + t * gap
            ex = human[:, t]
            data = _block(kpts[ex, t], scores[ex, t], depth[ex, t], inv)
            if t == 0 and s > 0 and cur2pre.shape[0] and num_frames > 1:
                _, pre = frames[starts[s]]
                ok = cur2pre != -1
                ci = np.arange(len(cur2pre))[ok]
                pi = cur2pre[ok]
                ps, cs = pre[pi][:, :, 3:4], data[ci][:, :, 3:4]
                data[ci, :, 3:4] = (ps + cs) / 2
                data[ci, :, 0:3] = (ps * pre[pi][:, :, 0:3]
                                    + cs * data[ci][:, :, 0:3]) / (ps + cs)
            frames[f] = (pids[ex], data)
    return frames, max_pid


def tracks_mismatch(got: Tuple[Dict, int], want: Tuple[Dict, int]) -> int:
    """How many frames, identities and pose entries of two associations
    differ (0: equal, bit for bit)."""
    (fa, na), (fb, nb) = got, want
    bad = int(na != nb) + len(set(fa) ^ set(fb))
    for k in set(fa) & set(fb):
        pa, da = fa[k]
        pb, db = fb[k]
        if pa.shape != pb.shape or da.shape != db.shape:
            bad += 1
            continue
        bad += int(np.sum(pa != pb)) + int(np.sum(da != db))
    return bad
