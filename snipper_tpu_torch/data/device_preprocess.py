"""The warps on the device: the port's own copy of
``snipper_tpu/data/device_preprocess.py``, the inference warp (``:35-95``)
and the train warp (``:98-154``).

The host pipeline (``infer/pipeline.py::iter_snippet_samples``) warps each
frame with the numpy ``data/transforms.py::warp_affine``; with
``warp_on_device`` it yields the decoded uint8 frames and the forward
affine instead, and this module does the warp and the ``/255`` where the
forward runs, so the host only decodes JPEGs.

The inference transform is an axis-aligned affine (a centre crop-resize,
no rotation), so the bilinear warp is separable: every output row reads two
source rows, every output column two source columns. Each axis gets the
two clamped source indices ``floor(s)`` and ``floor(s) + 1`` of
``s = scale * dst + offset``, with weights ``1 - f`` and ``f``, each zeroed
where its index falls outside ``[0, size)`` (``cv2.warpAffine``
INTER_LINEAR with a zero border, the weights that JAX's ``_axis_weights``
puts in its dense matrices). Rows are gathered and blended first, then
columns: O(output pixels) work in exact f32 with no matrix product, so no
TF32 setting touches it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _axis_taps(scale: float, offset: float, out_size: int, src_size: int,
               device, flip: bool = False):
    """``(i0, i1, w0, w1)``: the two clamped source indices of each output
    position along one axis and their bilinear weights, zero where the
    index lies outside ``[0, src_size)``. ``flip`` mirrors the source
    (index ``i`` reads ``src_size - 1 - i``)."""
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    s = dst * scale + offset
    s0 = torch.floor(s)
    f = s - s0
    i0 = s0.to(torch.int64)
    i1 = i0 + 1
    w0 = (1.0 - f) * ((i0 >= 0) & (i0 < src_size))
    w1 = f * ((i1 >= 0) & (i1 < src_size))
    i0 = i0.clamp(0, src_size - 1)
    i1 = i1.clamp(0, src_size - 1)
    if flip:
        i0, i1 = src_size - 1 - i0, src_size - 1 - i1
    return i0, i1, w0, w1


def warp_affine_device(imgs: torch.Tensor, inv_trans,
                       out_shape: Tuple[int, int],
                       do_flip: bool = False) -> torch.Tensor:
    """Warp ``imgs [..., H, W, C]`` (uint8 or float, on any device) by an
    axis-aligned inverse affine ``inv_trans [2, 3]`` (dst -> src:
    ``src_x = m[0,0]*x + m[0,2]``, ``src_y = m[1,1]*y + m[1,2]``;
    ``m[0,1]`` and ``m[1,0]`` must be zero) to ``out_shape (out_h, out_w)``
    and divide by 255. ``do_flip`` mirrors x first. Returns float32
    ``[..., out_h, out_w, C]`` on the device of ``imgs``.

    ``inv_trans`` is a host array: its four numbers are rounded to f32, as
    JAX's are, and the indices are built on the device from them."""
    m = np.asarray(inv_trans, np.float32)
    if m.shape != (2, 3):
        raise ValueError(f"inv_trans must be [2, 3], got {m.shape}")
    if m[0, 1] != 0 or m[1, 0] != 0:
        raise ValueError("the device warp supports axis-aligned transforms "
                         "only")
    out_h, out_w = out_shape
    H, W = imgs.shape[-3], imgs.shape[-2]
    dev = imgs.device
    iy0, iy1, wy0, wy1 = _axis_taps(float(m[1, 1]), float(m[1, 2]), out_h,
                                    H, dev)
    ix0, ix1, wx0, wx1 = _axis_taps(float(m[0, 0]), float(m[0, 2]), out_w,
                                    W, dev, flip=do_flip)
    # rows, then columns: JAX's order of the two contractions
    rows = (imgs.index_select(-3, iy0).float() * wy0[:, None, None]
            + imgs.index_select(-3, iy1).float() * wy1[:, None, None])
    out = (rows.index_select(-2, ix0) * wx0[:, None]
           + rows.index_select(-2, ix1) * wx1[:, None])
    return out / 255.0


def invert_axis_aligned(trans: np.ndarray) -> np.ndarray:
    """Invert a 2x3 axis-aligned forward affine (dst = trans @ src); raises
    ``ValueError`` on one with rotation or shear."""
    t = np.asarray(trans, np.float64)
    if abs(t[0, 1]) >= 1e-9 or abs(t[1, 0]) >= 1e-9:
        raise ValueError("the device warp supports axis-aligned transforms "
                         "only")
    inv = np.zeros((2, 3), np.float32)
    inv[0, 0] = 1.0 / t[0, 0]
    inv[1, 1] = 1.0 / t[1, 1]
    inv[0, 2] = -t[0, 2] / t[0, 0]
    inv[1, 2] = -t[1, 2] / t[1, 1]
    return inv


def preprocess_snippet_device(raw_imgs, trans: np.ndarray,
                              input_shape: Tuple[int, int],
                              device=None) -> torch.Tensor:
    """The device counterpart of the host warp in
    ``iter_snippet_samples``: uint8 frames ``[T, H, W, 3]`` (numpy, or a
    tensor, ideally in pinned memory) + the forward centre-crop affine ->
    ``[T, out_h, out_w, 3]`` float32 in [0, 1] on ``device`` (default: the
    frames' own device). The frames are copied as uint8, without blocking
    the host."""
    x = torch.as_tensor(raw_imgs)
    if device is not None:
        x = x.to(device, non_blocking=True)
    return warp_affine_device(x, invert_axis_aligned(trans),
                              tuple(input_shape))


def warp_train_batch_device(raw: torch.Tensor, inv: torch.Tensor,
                            color: torch.Tensor,
                            out_shape: Tuple[int, int]) -> torch.Tensor:
    """The train warp on the tensors' device: flip (folded into ``inv`` by
    ``transforms.fold_flip_inverse``) + rotated bilinear warp + /255 +
    per-channel color scale + clip, the device counterpart of the host
    ``native_ops.warp_patch`` (reference ``generate_patch_image`` + color
    jitter, ``datasets/transforms.py:137-144``).

    ``raw [B, T, H, W, 3]`` uint8, zero-padded to the batch's shared shape
    (the zero pad is the warp's zero border: the valid test uses the padded
    ``H`` and ``W``, as JAX's does), ``inv [B, T, 2, 3]`` dst -> src
    affines, ``color [B, 3]``. Returns float32 ``[B, T, out_h, out_w, 3]``
    in [0, 1].

    The train augmentation rotates (±25°, ``get_aug_config``), so the
    separable inference warp does not apply: each output pixel gathers
    its four corners over the flattened frame with int64 indices, one
    corner at a time, and blends them in f32 in JAX's order. The corners
    are gathered from the uint8 frames and converted after the gather
    (the same values as JAX's gather from an f32 copy, without that copy
    of the padded frames)."""
    out_h, out_w = out_shape
    B, T, H, W, C = raw.shape
    dev = raw.device
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    m = inv.to(torch.float32)[..., None, None]      # [B, T, 2, 3, 1, 1]
    sx = m[:, :, 0, 0] * xs + m[:, :, 0, 1] * ys[:, None] + m[:, :, 0, 2]
    sy = m[:, :, 1, 0] * xs + m[:, :, 1, 1] * ys[:, None] + m[:, :, 1, 2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    flat = raw.reshape(B, T, H * W, C)
    out = torch.zeros((B, T, out_h, out_w, C), dtype=torch.float32,
                      device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = (yi.clamp(0, H - 1).to(torch.int64) * W
                   + xi.clamp(0, W - 1).to(torch.int64))
            g = torch.gather(flat, 2, idx.reshape(B, T, -1, 1).expand(
                B, T, out_h * out_w, C)).to(torch.float32)
            w = ((fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
                 * valid)
            out = out + w[..., None] * g.reshape(B, T, out_h, out_w, C)
    out = out / 255.0 * color.to(torch.float32)[:, None, None, None, :]
    return torch.clamp(out, 0.0, 1.0)
