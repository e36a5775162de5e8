"""Multi-scale deformable attention sampling (MSDA): the plain PyTorch
version and the wrapper of the Hopper kernel.

``ms_deform_attn`` is what the model calls. It chooses by the device of its
inputs alone: tensors on the CPU take the plain version,
:func:`ms_deform_attn_torch`; tensors on a CUDA device launch the kernel
``msda_forward`` (``ops/csrc/msda_forward.cu``), or the wrapper raises.
There is no fallback from the card to the plain version.

Both compute the JAX package's ``ms_deform_attn_core``
(``snipper_tpu/ops/deform_attn.py:47``) and ``ms_deform_attn_pallas``
(``snipper_tpu/ops/pallas_deform.py:107``): bilinear
``grid_sample(align_corners=False, padding_mode="zeros")`` of each level at
``loc``, weighted by ``attn`` and summed over levels and points.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

MAX_LEVELS = 8  # MSDA_MAX_LEVELS in msda_forward.cu


def ms_deform_attn_torch(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         loc: torch.Tensor,
                         attn: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.grid_sample`` per level.

    Args:
      value: ``[N, S, H, D]``, ``S = sum_l h_l * w_l``.
      spatial_shapes: ``(h_l, w_l)`` per level.
      loc: ``[N, Lq, H, L, P, 2]`` normalized ``(x, y)``.
      attn: ``[N, Lq, H, L, P]``.

    Returns ``[N, Lq, H * D]`` in the value's dtype, summed in f32.
    """
    N, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    vals = value.float().split([h * w for h, w in spatial_shapes], dim=1)
    out = torch.zeros(N, Lq, H, D, dtype=torch.float32, device=value.device)
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = vals[lvl].permute(0, 2, 3, 1).reshape(N * H, D, h, w)
        g = 2 * loc[:, :, :, lvl].float() - 1                 # [N,Lq,H,P,2]
        g = g.permute(0, 2, 1, 3, 4).reshape(N * H, Lq, P, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)               # [NH, D, Lq, P]
        s = s.reshape(N, H, D, Lq, P)
        a = attn[:, :, :, lvl].float().permute(0, 2, 1, 3)   # [N, H, Lq, P]
        out = out + torch.einsum("nhdqp,nhqp->nqhd", s, a)
    return out.reshape(N, Lq, H * D).to(value.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """Build (at first use) and load ``libmsda.so``, with the C signatures
    declared: pointers and the stream as ``c_void_p``, sizes as int64."""
    from snipper_tpu_torch.ops import _build

    lib = _build.load("msda_forward.cu", "libmsda.so")
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5
                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    for fn in (lib.msda_forward_f32, lib.msda_forward_bf16):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def msda_forward(value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`ms_deform_attn_torch`. Raises on anything the kernel does not
    take."""
    N, S, H, D = value.shape
    if loc.dim() != 6 or attn.dim() != 5:
        raise ValueError(f"loc must be [N, Lq, H, L, P, 2] and attn "
                         f"[N, Lq, H, L, P] (got {tuple(loc.shape)}, "
                         f"{tuple(attn.shape)})")
    _, Lq, _, L, P, _ = loc.shape
    if tuple(loc.shape) != (N, Lq, H, L, P, 2) \
            or tuple(attn.shape) != (N, Lq, H, L, P):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, loc "
                         f"{tuple(loc.shape)}, attn {tuple(attn.shape)}")
    if not 1 <= L <= MAX_LEVELS or len(spatial_shapes) != L:
        raise ValueError(f"need 1 <= L <= {MAX_LEVELS} levels matching "
                         f"spatial_shapes (got L={L}, {spatial_shapes})")
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has S={S} pixels, spatial_shapes "
                         f"{spatial_shapes} sum to another count")
    for name, t in (("value", value), ("loc", loc), ("attn", attn)):
        if t.device.type != "cuda" or t.device != value.device:
            raise ValueError(f"{name} must lie on value's CUDA device "
                             f"(got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError(f"loc and attn must be float32 (got {loc.dtype}, "
                        f"{attn.dtype})")
    if value.dtype == torch.float32:
        fn_name = "msda_forward_f32"
    elif value.dtype == torch.bfloat16:
        fn_name = "msda_forward_bf16"
    else:
        raise TypeError(f"value must be float32 or bfloat16 "
                        f"(got {value.dtype})")
    fn = getattr(_kernel_lib(), fn_name)
    out = torch.empty(N, Lq, H * D, dtype=value.dtype, device=value.device)
    starts, shapes = [], []
    s0 = 0
    for h, w in spatial_shapes:
        shapes += [int(h), int(w)]
        starts.append(s0)
        s0 += int(h) * int(w)
    shapes_c = (ctypes.c_int64 * (2 * L))(*shapes)
    starts_c = (ctypes.c_int64 * L)(*starts)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                 out.data_ptr(), N, S, H, D, Lq, L, P,
                 ctypes.cast(shapes_c, ctypes.c_void_p),
                 ctypes.cast(starts_c, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"msda_forward launch failed: CUDA error {err}")
    ms_deform_attn.launches += 1
    return out


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """MSDA forward, by device: the plain version for CPU tensors, the
    ``msda_forward`` kernel for CUDA tensors. ``ms_deform_attn.launches``
    counts the kernel's launches."""
    if value.device.type == "cpu":
        return ms_deform_attn_torch(value, spatial_shapes, loc, attn)
    return msda_forward(value, spatial_shapes, loc, attn)


ms_deform_attn.launches = 0
