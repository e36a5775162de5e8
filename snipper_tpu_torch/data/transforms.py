"""Snippet augmentation and the host warp (numpy, cv2-free): the port's own
copy of the host functions of ``snipper_tpu/data/transforms.py``.

- ``get_aug_config``: rot ~ clip(N(0,1),±1)*25° w.p. 0.6, flip w.p. 0.5,
  per-channel color scale U(0.8, 1.2), center jitter U(0.7, 1.3), crop box
  sized to cover the input aspect (reference ``transforms.py:82-134``),
  drawn from the caller's ``numpy.random.Generator`` in JAX's order, so
  one seed gives JAX's augmentation.
- ``get_aug_config_coco``: a fake camera-motion sequence from one still,
  rotation and center interpolated over the snippet (reference
  ``transforms.py:14-78``).
- ``gen_trans_from_patch``: 3-point affine identical to the cv2
  construction (reference ``datasets/transforms.py:156-186``).
- ``warp_affine``: inverse-mapped bilinear warp with zero border,
  ``cv2.warpAffine(..., INTER_LINEAR)`` semantics.
- ``generate_patch_image``: flip + warp + ``/255``.
- ``fold_flip_inverse``: the dst -> src affine with the flip folded in,
  for the device warp of raw frames.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def rotate_2d(pt, rot_rad):
    sn, cs = math.sin(rot_rad), math.cos(rot_rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs],
                    np.float32)


def _affine_from_3pt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine M with dst_i = M @ [src_i, 1] (cv2.getAffineTransform)."""
    A = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1)  # [3, 3]
    M = np.linalg.solve(A, dst)                                     # [3, 2]
    return M.T.astype(np.float64)                                   # [2, 3]


def gen_trans_from_patch(c_x, c_y, src_width, src_height, dst_width,
                         dst_height, rot, inv=False) -> np.ndarray:
    rot_rad = math.pi * rot / 180.0
    src_center = np.array([c_x, c_y], np.float32)
    src_down = rotate_2d(np.array([0, src_height * 0.5], np.float32), rot_rad)
    src_right = rotate_2d(np.array([src_width * 0.5, 0], np.float32), rot_rad)
    dst_center = np.array([dst_width * 0.5, dst_height * 0.5], np.float32)
    dst_down = np.array([0, dst_height * 0.5], np.float32)
    dst_right = np.array([dst_width * 0.5, 0], np.float32)

    src = np.stack([src_center, src_center + src_down, src_center + src_right])
    dst = np.stack([dst_center, dst_center + dst_down, dst_center + dst_right])
    if inv:
        return _affine_from_3pt(dst, src)
    return _affine_from_3pt(src, dst)


def get_aug_config(img_shape: Tuple[float, float],
                   input_shape: Tuple[int, int],
                   augmentation: bool,
                   rng: np.random.Generator | None = None):
    """``img_shape`` is (width, height); ``input_shape`` is (height, width)
    — the reference's (confusing but kept) convention."""
    rng = rng or np.random.default_rng()
    if augmentation:
        rot = (float(np.clip(rng.standard_normal(), -1, 1)) * 25.0
               if rng.random() <= 0.6 else 0.0)
        do_flip = rng.random() <= 0.5
        color_scale = [float(rng.uniform(0.8, 1.2)) for _ in range(3)]
        c_x_scale = rng.uniform(0.7, 1.3)
        c_y_scale = rng.uniform(0.7, 1.3)
        bb_c_x = img_shape[0] * 0.5 * c_x_scale
        bb_c_y = img_shape[1] * 0.5 * c_y_scale
        if do_flip:
            bb_c_x = img_shape[0] - bb_c_x - 1
    else:
        rot, do_flip, color_scale = 0.0, False, [1.0, 1.0, 1.0]
        bb_c_x = img_shape[0] * 0.5
        bb_c_y = img_shape[1] * 0.5

    bbx_scale = max(img_shape[0] / input_shape[1], img_shape[1] / input_shape[0])
    bb_width = input_shape[1] * bbx_scale
    bb_height = input_shape[0] * bbx_scale
    bbx = [bb_c_x, bb_c_y, bb_width, bb_height]
    trans = gen_trans_from_patch(bb_c_x, bb_c_y, bb_width, bb_height,
                                 input_shape[1], input_shape[0], rot)
    inv_trans = gen_trans_from_patch(bb_c_x, bb_c_y, bb_width, bb_height,
                                     input_shape[1], input_shape[0], rot,
                                     inv=True)
    return rot, do_flip, color_scale, bbx, trans, inv_trans


def get_aug_config_coco(img_shape, input_shape, seq_length: int, aug: bool,
                        rng: np.random.Generator | None = None):
    """Fake camera-motion sequence from one still image."""
    rng = rng or np.random.default_rng()
    bbx_scale = max(img_shape[0] / input_shape[1], img_shape[1] / input_shape[0])
    bb_width = input_shape[1] * bbx_scale
    bb_height = input_shape[0] * bbx_scale
    if aug:
        do_flip = rng.random() <= 0.5
        color_scale = [float(rng.uniform(0.8, 1.2)) for _ in range(3)]
        bb_c_x = img_shape[0] * 0.5 * rng.uniform(0.7, 1.3)
        bb_c_y = img_shape[1] * 0.5 * rng.uniform(0.7, 1.3)
        cx_gap = (bb_c_x - img_shape[0] * 0.5) / seq_length
        cy_gap = (bb_c_y - img_shape[1] * 0.5) / seq_length
        rot = float(np.clip(rng.standard_normal(), -1, 1)) * 30.0
        rot_gap = rot / seq_length

        rots, bbxes, trans_l, inv_l = [], [], [], []
        for t in range(seq_length):
            rot_t = rot_gap * (t + 1)
            cx_t = cx_gap * (t + 1) + img_shape[0] * 0.5
            cy_t = cy_gap * (t + 1) + img_shape[1] * 0.5
            if do_flip:
                cx_t = img_shape[0] - cx_t - 1
            bbxes.append([cx_t, cy_t, bb_width, bb_height])
            trans_l.append(gen_trans_from_patch(
                cx_t, cy_t, bb_width, bb_height, input_shape[1],
                input_shape[0], rot_t))
            inv_l.append(gen_trans_from_patch(
                cx_t, cy_t, bb_width, bb_height, input_shape[1],
                input_shape[0], rot_t, inv=True))
            rots.append(rot_t)
    else:
        do_flip, color_scale = False, [1.0, 1.0, 1.0]
        cx, cy = img_shape[0] * 0.5, img_shape[1] * 0.5
        rots = [0.0]
        bbxes = [[cx, cy, bb_width, bb_height]]
        trans_l = [gen_trans_from_patch(cx, cy, bb_width, bb_height,
                                        input_shape[1], input_shape[0], 0.0)]
        inv_l = [gen_trans_from_patch(cx, cy, bb_width, bb_height,
                                      input_shape[1], input_shape[0], 0.0,
                                      inv=True)]
    return rots, do_flip, color_scale, bbxes, trans_l, inv_l


def _invert_affine(M: np.ndarray) -> np.ndarray:
    A = M[:, :2]
    b = M[:, 2]
    Ainv = np.linalg.inv(A)
    return np.concatenate([Ainv, (-Ainv @ b)[:, None]], axis=1)


def warp_affine(img: np.ndarray, trans: np.ndarray,
                out_shape: Tuple[int, int]) -> np.ndarray:
    """Bilinear warp of ``img [H, W, C]`` (uint8 or float) by the FORWARD
    affine ``trans`` (dst = trans @ src), zero border; output
    ``[out_h, out_w, C]`` float32."""
    out_h, out_w = out_shape
    Minv = _invert_affine(np.asarray(trans, np.float64))
    ys, xs = np.meshgrid(np.arange(out_h, dtype=np.float64),
                         np.arange(out_w, dtype=np.float64), indexing="ij")
    sx = Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]
    sy = Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]

    h, w = img.shape[:2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = (sx - x0).astype(np.float32)
    fy = (sy - y0).astype(np.float32)
    out = np.zeros((out_h, out_w, img.shape[2]), np.float32)
    imgf = img.astype(np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = (x0 + dx).astype(np.int64)
            yi = (y0 + dy).astype(np.int64)
            wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy))
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xi_c = np.clip(xi, 0, w - 1)
            yi_c = np.clip(yi, 0, h - 1)
            out += (wgt * valid)[..., None] * imgf[yi_c, xi_c]
    return out


def fold_flip_inverse(trans: np.ndarray, do_flip: bool,
                      src_w: int) -> np.ndarray:
    """dst->src inverse affine with the horizontal flip FOLDED IN.

    ``warp_patch`` flips the source first, then warps with the forward
    ``trans`` — equivalent to sampling the UNFLIPPED source at
    ``x_u = (src_w - 1) - x_flipped``. Folding the mirror into the inverse
    affine lets the device warp consume raw (unflipped) frames with one
    2x3 matrix per frame and stay bit-equivalent to the host path."""
    inv = _invert_affine(np.asarray(trans, np.float64))
    if do_flip:
        inv = np.stack([
            np.array([-inv[0, 0], -inv[0, 1], src_w - 1.0 - inv[0, 2]]),
            inv[1],
        ])
    return inv.astype(np.float32)


def generate_patch_image(img: np.ndarray, do_flip: bool, trans: np.ndarray,
                         input_shape: Tuple[int, int]) -> np.ndarray:
    """Flip + warp + /255 (reference ``generate_patch_image``)."""
    if do_flip:
        img = img[:, ::-1, :]
    patch = warp_affine(img, trans, input_shape)
    return patch / 255.0


def trans_point2d(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to points ``[2, ...]`` (reference layout)."""
    shape = pts.shape
    flat = pts.reshape(2, -1)
    out = trans[:, :2] @ flat + trans[:, 2:3]
    return out.reshape(shape)


def apply_affine_to_kpts(kpts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to ``[..., 2]`` keypoints."""
    return kpts @ np.asarray(trans)[:, :2].T + np.asarray(trans)[:, 2]
