"""Gaussian-blurred keypoint heatmap targets on the model's device.

Counterpart of ``snipper_tpu/losses/heatmap.py:22-98``: one batched
scatter of the visible keypoints into binary maps, then a reflect-padded
separable blur by two dense blur matrices in f32. The blur follows
``torchvision.transforms.functional.gaussian_blur``
(``sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8``, normalized kernel, reflect
padding), which the reference calls at ``models/model.py:478``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snipper_tpu_torch.ops.deform_attn import device_constant


def heatmap_kernel_size(h: int, w: int) -> int:
    """Reference ``models/model.py:456``, clamped to >= 1 so that maps
    below 10 px get an identity blur."""
    k = max(h // 10 + (h // 10) % 2 - 1, w // 10 + (w // 10) % 2 - 1)
    return max(k, 1)


def _reflect_index(j: int, size: int) -> int:
    """Index under repeated 'reflect' (mirror-without-edge) padding."""
    if size == 1:
        return 0
    period = 2 * size - 2
    j = j % period
    return j if j < size else period - j


@functools.lru_cache(maxsize=None)
def blur_matrix(size: int, ksize: int) -> np.ndarray:
    """Dense ``[size, size]`` f32 matrix of a 1D reflect-padded Gaussian
    blur (row i of the output = blurred row i)."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) * 0.5
    x = np.linspace(-half, half, ksize)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    kernel = (pdf / pdf.sum()).astype(np.float32)
    B = np.zeros((size, size), np.float32)
    for i in range(size):
        for k in range(ksize):
            B[i, _reflect_index(i + k - ksize // 2, size)] += kernel[k]
    return B


def scatter_keypoint_maps(kpts2d: torch.Tensor, valid: torch.Tensor,
                          t_frames: int, h: int, w: int) -> torch.Tensor:
    """Binary keypoint maps ``[B, T, h, w, K]`` over the observed frames
    (reference ``generate_heatmap``, ``models/model.py:454-474``): a pixel
    is 1 if a visible keypoint of that type falls into it. Coordinates
    truncate toward zero, as the reference's ``.long()``: x in (-1, 0)
    lands in column 0."""
    B, M, _, K, _ = kpts2d.shape
    k = kpts2d[:, :, :t_frames].to(torch.float32)
    x = torch.trunc(k[..., 0] * w).long()
    y = torch.trunc(k[..., 1] * h).long()
    vis = (k[..., 2] > 0) & valid[:, :, None, None].bool()
    ok = vis & (x >= 0) & (x < w) & (y >= 0) & (y < h)
    flat = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)           # [B, M, T, K]
    dev = kpts2d.device
    b_idx = torch.arange(B, device=dev)[:, None, None, None].expand_as(flat)
    t_idx = torch.arange(t_frames, device=dev)[None, None, :, None] \
        .expand_as(flat)
    k_idx = torch.arange(K, device=dev)[None, None, None, :].expand_as(flat)
    maps = torch.zeros(B, t_frames, h * w, K, dtype=torch.float32,
                       device=dev)
    maps.index_put_((b_idx, t_idx, flat, k_idx), ok.to(torch.float32),
                    accumulate=True)
    return maps.clamp(max=1.0).reshape(B, t_frames, h, w, K)


def gaussian_blur_maps(maps: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable reflect-padded Gaussian blur over (h, w) of
    ``[B, T, h, w, K]`` by two blur matrices in f32 (full f32 while
    ``torch.backends.cuda.matmul.allow_tf32`` keeps its default, False)."""
    h, w = maps.shape[2], maps.shape[3]
    By = device_constant(blur_matrix(h, ksize), maps)
    Bx = device_constant(blur_matrix(w, ksize), maps)
    out = torch.einsum("ij,btjwk->btiwk", By, maps)
    return torch.einsum("ij,btujk->btuik", Bx, out)


def heatmap_targets(kpts2d, valid, t_frames, h, w):
    maps = scatter_keypoint_maps(kpts2d, valid, t_frames, h, w)
    return gaussian_blur_maps(maps, heatmap_kernel_size(h, w))
