"""Multi-scale deformable attention sampling (MSDA): the plain PyTorch
version, the wrappers of the two Hopper kernels and their autograd pairing.

``ms_deform_attn`` is what the model calls. It chooses by the device of its
inputs alone: tensors on the CPU take the plain version,
:func:`ms_deform_attn_torch`, which autograd differentiates through
``F.grid_sample``; tensors on a CUDA device go through
:class:`MSDAFunction`, whose forward launches ``msda_forward``
(``ops/csrc/msda_forward.cu``) and whose backward launches
``msda_backward`` (``ops/csrc/msda_backward.cu``), or the wrappers raise.
There is no fallback from the card to the plain version.

Both compute the JAX package's ``ms_deform_attn_core``
(``snipper_tpu/ops/deform_attn.py:47``) and ``ms_deform_attn_pallas``
(``snipper_tpu/ops/pallas_deform.py:107``): bilinear
``grid_sample(align_corners=False, padding_mode="zeros")`` of each level at
``loc``, weighted by ``attn`` and summed over levels and points. The
autograd pairing is the counterpart of ``_pallas_with_vjp``
(``pallas_deform.py:390-402``), which saves the same three primals.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

MAX_LEVELS = 8  # MSDA_MAX_LEVELS in the kernels
MAX_BACKWARD_D = 128  # grad_out held in registers: msda_backward.cu
# pointer arguments of each library's C entry points (one per value dtype),
# before the sizes (N, S, H, D, Lq, L, P), the level table and the stream
_N_POINTERS = {"msda_forward": 4, "msda_backward": 7}


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

    Returns ``[N, Lq, H * D]`` in the value's dtype, summed in f32 (in f64
    for an f64 value), also under autocast.
    """
    N, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    cdt = torch.promote_types(value.dtype, torch.float32)
    with torch.autocast(value.device.type, enabled=False):
        vals = value.to(cdt).split([h * w for h, w in spatial_shapes], dim=1)
        out = torch.zeros(N, Lq, H, D, dtype=cdt, device=value.device)
        for lvl, (h, w) in enumerate(spatial_shapes):
            v = vals[lvl].permute(0, 2, 3, 1).reshape(N * H, D, h, w)
            g = 2 * loc[:, :, :, lvl].to(cdt) - 1               # [N,Lq,H,P,2]
            g = g.permute(0, 2, 1, 3, 4).reshape(N * H, Lq, P, 2)
            s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                              align_corners=False)             # [NH,D,Lq,P]
            s = s.reshape(N, H, D, Lq, P)
            a = attn[:, :, :, lvl].to(cdt).permute(0, 2, 1, 3)  # [N,H,Lq,P]
            out = out + torch.einsum("nhdqp,nhqp->nqhd", s, a)
    return out.reshape(N, Lq, H * D).to(value.dtype)


def ms_deform_attn_torch_vjp(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             loc: torch.Tensor, attn: torch.Tensor,
                             grad_out: torch.Tensor):
    """Plain backward: ``(d_value, d_loc, d_attn)``, the VJP of
    :func:`ms_deform_attn_torch` at ``grad_out`` by ``torch.autograd.grad``
    (the counterpart of ``jax.vjp`` of ``ms_deform_attn_core``)."""
    with torch.enable_grad():
        v, lo, a = (t.detach().requires_grad_(True)
                    for t in (value, loc, attn))
        out = ms_deform_attn_torch(v, spatial_shapes, lo, a)
        return torch.autograd.grad(out, (v, lo, a), grad_out)


@functools.lru_cache(maxsize=None)
def _kernel_lib(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``lib<name>.so`` from ``<name>.cu``,
    with the C signatures declared: pointers and the stream as
    ``c_void_p``, sizes as int64."""
    from snipper_tpu_torch.ops import _build

    lib = _build.load(f"{name}.cu", f"lib{name}.so")
    sizes = [ctypes.c_int64] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    for kind in ("f32", "bf16"):
        fn = getattr(lib, f"{name}_{kind}")
        fn.argtypes = [ctypes.c_void_p] * _N_POINTERS[name] + sizes
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(name, value, spatial_shapes, loc, attn):
    """Shapes, devices, dtypes and contiguity the kernels take; returns
    ``(N, S, H, D, Lq, L, P)``."""
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
    for tname, t in (("value", value), ("loc", loc), ("attn", attn)):
        if t.device.type != "cuda" or t.device != value.device:
            raise ValueError(f"{name}: {tname} must lie on value's CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError(f"{name}: loc and attn must be float32 (got "
                        f"{loc.dtype}, {attn.dtype})")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: value must be float32 or bfloat16 "
                        f"(got {value.dtype})")
    return N, S, H, D, Lq, L, P


def _level_table(spatial_shapes):
    """``(shapes, starts)`` as ctypes int64 arrays; the kernels copy them
    into their parameter block."""
    L = len(spatial_shapes)
    starts, shapes = [], []
    s0 = 0
    for h, w in spatial_shapes:
        shapes += [int(h), int(w)]
        starts.append(s0)
        s0 += int(h) * int(w)
    return ((ctypes.c_int64 * (2 * L))(*shapes),
            (ctypes.c_int64 * L)(*starts))


def msda_forward(value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream; same contract as
    :func:`ms_deform_attn_torch`. Raises on anything the kernel does not
    take."""
    N, S, H, D, Lq, L, P = _check_inputs("msda_forward", value,
                                         spatial_shapes, loc, attn)
    kind = "f32" if value.dtype == torch.float32 else "bf16"
    fn = getattr(_kernel_lib("msda_forward"), f"msda_forward_{kind}")
    out = torch.empty(N, Lq, H * D, dtype=value.dtype, device=value.device)
    shapes_c, starts_c = _level_table(spatial_shapes)
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


def msda_backward(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  loc: torch.Tensor, attn: torch.Tensor,
                  grad_out: torch.Tensor):
    """Launch the backward kernel on the current stream; same contract as
    :func:`ms_deform_attn_torch_vjp`: ``(d_value, d_loc, d_attn)``, all
    three f32 whatever the value's dtype (autograd casts ``d_value`` to a
    bf16 value's dtype). ``grad_out [N, Lq, H*D]`` must have the value's
    dtype. Raises on anything the kernel does not take."""
    N, S, H, D, Lq, L, P = _check_inputs("msda_backward", value,
                                         spatial_shapes, loc, attn)
    if D > MAX_BACKWARD_D:
        raise ValueError(f"msda_backward takes D <= {MAX_BACKWARD_D} "
                         f"channels per head (got {D})")
    if tuple(grad_out.shape) != (N, Lq, H * D) \
            or grad_out.dtype != value.dtype \
            or grad_out.device != value.device \
            or not grad_out.is_contiguous():
        raise ValueError(f"grad_out must be a contiguous {value.dtype} "
                         f"[{N}, {Lq}, {H * D}] on {value.device} (got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)} on "
                         f"{grad_out.device})")
    kind = "f32" if value.dtype == torch.float32 else "bf16"
    fn = getattr(_kernel_lib("msda_backward"), f"msda_backward_{kind}")
    dev = value.device
    # the kernel adds into d_value with atomics, so it starts at zero
    d_value = torch.zeros(N, S, H, D, dtype=torch.float32, device=dev)
    d_loc = torch.empty(N, Lq, H, L, P, 2, dtype=torch.float32, device=dev)
    d_attn = torch.empty(N, Lq, H, L, P, dtype=torch.float32, device=dev)
    shapes_c, starts_c = _level_table(spatial_shapes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                 grad_out.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
                 d_attn.data_ptr(), N, S, H, D, Lq, L, P,
                 ctypes.cast(shapes_c, ctypes.c_void_p),
                 ctypes.cast(starts_c, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"msda_backward launch failed: CUDA error {err}")
    ms_deform_attn.backward_launches += 1
    return d_value, d_loc, d_attn


class MSDAFunction(torch.autograd.Function):
    """The two kernels as one differentiable op: forward ``msda_forward``,
    backward ``msda_backward``, saving value, loc and attn. The f32
    ``d_value`` of a bf16 value is cast to bf16 by autograd's engine,
    which gives each gradient its input's dtype."""

    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes):
        ctx.spatial_shapes = tuple((int(h), int(w))
                                   for h, w in spatial_shapes)
        ctx.save_for_backward(value, loc, attn)
        return msda_forward(value, ctx.spatial_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        d_value, d_loc, d_attn = msda_backward(
            value, ctx.spatial_shapes, loc, attn,
            grad_out.to(value.dtype).contiguous())
        return d_value, d_loc, d_attn, None


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """MSDA, by device: the plain version for CPU tensors, the two kernels
    through :class:`MSDAFunction` for CUDA tensors.
    ``ms_deform_attn.launches`` counts the forward kernel's launches,
    ``ms_deform_attn.backward_launches`` the backward kernel's."""
    if value.device.type == "cpu":
        return ms_deform_attn_torch(value, spatial_shapes, loc, attn)
    return MSDAFunction.apply(value, loc, attn, spatial_shapes)


ms_deform_attn.launches = 0
ms_deform_attn.backward_launches = 0
