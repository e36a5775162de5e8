"""Host-side affine crop/resize for inference (numpy, cv2-free).

The port's own copy of the parts of ``snipper_tpu/data/transforms.py``
that the inference pipeline needs:

- ``gen_trans_from_patch``: 3-point affine identical to the cv2
  construction (reference ``datasets/transforms.py:156-186``).
- ``warp_affine``: inverse-mapped bilinear warp with zero border,
  ``cv2.warpAffine(..., INTER_LINEAR)`` semantics.
- ``generate_patch_image``: flip + warp + ``/255``.
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


def generate_patch_image(img: np.ndarray, do_flip: bool, trans: np.ndarray,
                         input_shape: Tuple[int, int]) -> np.ndarray:
    """Flip + warp + /255 (reference ``generate_patch_image``)."""
    if do_flip:
        img = img[:, ::-1, :]
    patch = warp_affine(img, trans, input_shape)
    return patch / 255.0
