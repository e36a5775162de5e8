"""Multi-scale deformable attention sampling (MSDA): the plain PyTorch
version, the wrappers of the two Hopper kernels and their autograd pairing.

``ms_deform_attn`` is what the model calls. It chooses by the device of its
inputs alone: tensors on the CPU take the plain version,
:func:`ms_deform_attn_torch`, which autograd differentiates through
``F.grid_sample``; tensors on a CUDA device go through the registered
operator ``torch.ops.snipper_tpu_torch.msda_forward``, which launches the
``msda_forward`` kernel (``ops/csrc/msda_forward.cu``) and whose autograd
formula calls ``torch.ops.snipper_tpu_torch.msda_backward``, which launches
``msda_backward`` (``ops/csrc/msda_backward.cu``), or they raise. There is
no fallback from the card to the plain version.

The two operators (``torch.library.custom_op``, level shapes as a flat
``int[]``, CUDA kernels only) have fake implementations, so that
``torch.export`` traces the model into a graph with one
``msda_forward`` node per sampling call; the exported program launches the
same kernels. The plain version stays outside the operators: an
operator's body runs below autograd, where ``ms_deform_attn_torch_vjp``
could not differentiate.

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
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

MAX_LEVELS = 8  # MSDA_MAX_LEVELS in the kernels
MAX_BACKWARD_D = 128  # grad_out held in registers: msda_backward.cu
# pointer arguments of each library's C entry points (one per value dtype),
# before the sizes (N, S, H, D, Lq, L, P), the level table and the stream
_N_POINTERS = {"msda_forward": 4, "msda_backward": 9}


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
    for an f64 value).
    """
    N, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    cdt = torch.promote_types(value.dtype, torch.float32)
    vals = value.to(cdt).split([h * w for h, w in spatial_shapes], dim=1)
    out = torch.zeros(N, Lq, H, D, dtype=cdt, device=value.device)
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = vals[lvl].permute(0, 2, 3, 1).reshape(N * H, D, h, w)
        g = 2 * loc[:, :, :, lvl].to(cdt) - 1                   # [N,Lq,H,P,2]
        g = g.permute(0, 2, 1, 3, 4).reshape(N * H, Lq, P, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)                 # [NH,D,Lq,P]
        s = s.reshape(N, H, D, Lq, P)
        a = attn[:, :, :, lvl].to(cdt).permute(0, 2, 1, 3)      # [N,H,Lq,P]
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


def flat_shapes(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """``[(h, w), ...]`` as the operators' flat ``[h0, w0, h1, w1, ...]``."""
    return [int(v) for hw in spatial_shapes for v in hw]


def _pairs(shapes: List[int]) -> List[Tuple[int, int]]:
    return [(shapes[i], shapes[i + 1]) for i in range(0, len(shapes), 2)]


def msda_forward(value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream through the
    registered operator; same contract as :func:`ms_deform_attn_torch`.
    Raises on anything the kernel does not take."""
    _check_inputs("msda_forward", value, spatial_shapes, loc, attn)
    return torch.ops.snipper_tpu_torch.msda_forward(
        value, flat_shapes(spatial_shapes), loc, attn)


@torch.library.custom_op("snipper_tpu_torch::msda_forward", mutates_args=(),
                         device_types="cuda")
def _msda_forward_op(value: torch.Tensor, shapes: List[int],
                     loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA body: one launch, counted in
    ``ms_deform_attn.launches``."""
    spatial_shapes = _pairs(shapes)
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
    ms_deform_attn.launches_by_dtype[kind] += 1
    return out


@_msda_forward_op.register_fake
def _(value, shapes, loc, attn):
    N, _, H, D = value.shape
    return value.new_empty(N, loc.shape[1], H * D)


def msda_forward_flops(value_shape, shapes, loc_shape, attn_shape,
                       out_shape=None, **kwargs) -> int:
    """Operations of one ``msda_forward`` from its arguments' shapes, in
    ``torch.utils.flop_counter``'s form (``FlopCounterMode(custom_mapping=
    {torch.ops.snipper_tpu_torch.msda_forward: msda_forward_flops})``):
    per sampled tap, its four bilinear corner weights times the attention
    weight (8: the corner product and the scaling) and, per corner, D
    multiply-adds (8 D)."""
    N, Lq, H, L, P = attn_shape
    return N * Lq * H * L * P * (8 * value_shape[-1] + 8)


def backward_plan(N: int, S: int, H: int, Lq: int, P: int,
                  spatial_shapes: Sequence[Tuple[int, int]]):
    """How ``msda_backward`` sums ``d_value``, from the shapes alone:
    ``(index_int32s, segs_int32s)``, the sizes of its scratch.

    The taps are sorted on the card by cell, the nw corner of their four,
    and each value row's owner sums the taps of the four cells it is a
    corner of, in a fixed order, into a ``d_value`` of the value's dtype.
    The scratch is the index, ``N*H*L*Lq*P`` entries of four int32 (query,
    attn, x, y), and the cells' segments, ``N*H*C`` pairs of int32,
    ``C = sum_l (h_l + 1)(w_l + 1)``. Raises ``ValueError`` for ``2^31`` taps or more in one (frame, head),
    which the index's int32 positions cannot number."""
    taps = len(spatial_shapes) * Lq * P
    if taps >= 2 ** 31:
        raise ValueError(f"msda_backward takes fewer than 2^31 taps per "
                         f"frame and head (got {taps})")
    cells = sum((h + 1) * (w + 1) for h, w in spatial_shapes)
    return N * H * taps * 4, N * H * cells * 2


def msda_backward(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  loc: torch.Tensor, attn: torch.Tensor,
                  grad_out: torch.Tensor):
    """Launch the backward kernels on the current stream through the
    registered operator; same contract as :func:`ms_deform_attn_torch_vjp`:
    ``(d_value, d_loc, d_attn)``, ``d_value`` in the value's dtype, the
    other two f32. ``grad_out [N, Lq, H*D]`` must have the value's dtype.
    Raises on anything the kernels do not take."""
    _check_backward_inputs(value, spatial_shapes, loc, attn, grad_out)
    return torch.ops.snipper_tpu_torch.msda_backward(
        value, flat_shapes(spatial_shapes), loc, attn, grad_out)


def _check_backward_inputs(value, spatial_shapes, loc, attn, grad_out):
    dims = _check_inputs("msda_backward", value, spatial_shapes, loc, attn)
    N, S, H, D, Lq, L, P = dims
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
    return dims


@torch.library.custom_op("snipper_tpu_torch::msda_backward",
                         mutates_args=(), device_types="cuda")
def _msda_backward_op(value: torch.Tensor, shapes: List[int],
                      loc: torch.Tensor, attn: torch.Tensor,
                      grad_out: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The operator's CUDA body: one call of the backward's three kernels,
    with the scratch :func:`backward_plan` sizes, counted in
    ``ms_deform_attn.backward_launches``."""
    spatial_shapes = _pairs(shapes)
    N, S, H, D, Lq, L, P = _check_backward_inputs(value, spatial_shapes,
                                                  loc, attn, grad_out)
    kind = "f32" if value.dtype == torch.float32 else "bf16"
    fn = getattr(_kernel_lib("msda_backward"), f"msda_backward_{kind}")
    dev = value.device
    n_index, n_segs = backward_plan(N, S, H, Lq, P, spatial_shapes)
    # every row of d_value is written once, in the value's dtype
    d_value = torch.empty(N, S, H, D, dtype=value.dtype, device=dev)
    index = torch.empty(n_index, dtype=torch.int32, device=dev)
    segs = torch.empty(n_segs, dtype=torch.int32, device=dev)
    d_loc = torch.empty(N, Lq, H, L, P, 2, dtype=torch.float32, device=dev)
    d_attn = torch.empty(N, Lq, H, L, P, dtype=torch.float32, device=dev)
    shapes_c, starts_c = _level_table(spatial_shapes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                 grad_out.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
                 d_attn.data_ptr(), index.data_ptr(), segs.data_ptr(),
                 N, S, H, D, Lq, L, P,
                 ctypes.cast(shapes_c, ctypes.c_void_p),
                 ctypes.cast(starts_c, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"msda_backward launch failed: CUDA error {err}")
    ms_deform_attn.backward_launches += 1
    ms_deform_attn.backward_launches_by_dtype[kind] += 1
    return d_value, d_loc, d_attn


@_msda_backward_op.register_fake
def _(value, shapes, loc, attn, grad_out):
    f32 = torch.float32
    return (value.new_empty(value.shape),
            loc.new_empty(loc.shape, dtype=f32),
            attn.new_empty(attn.shape, dtype=f32))


def _setup_context(ctx, inputs, output):
    value, shapes, loc, attn = inputs
    ctx.shapes = shapes
    ctx.save_for_backward(value, loc, attn)


def _backward(ctx, grad_out):
    """The two kernels as one differentiable op: the backward on the saved
    value, loc and attn, each gradient in its input's dtype."""
    value, loc, attn = ctx.saved_tensors
    d_value, d_loc, d_attn = torch.ops.snipper_tpu_torch.msda_backward(
        value, ctx.shapes, loc, attn, grad_out.to(value.dtype).contiguous())
    return d_value, None, d_loc, d_attn


_msda_forward_op.register_autograd(_backward, setup_context=_setup_context)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """MSDA, by device: the plain version for CPU tensors, the two kernels
    through the registered operator for CUDA tensors.
    ``ms_deform_attn.launches`` counts the forward kernel's launches,
    ``ms_deform_attn.backward_launches`` the backward's calls; the
    ``launches_by_dtype`` and ``backward_launches_by_dtype`` dicts split
    them by the value's dtype (``"f32"``, ``"bf16"``)."""
    if value.device.type == "cpu":
        return ms_deform_attn_torch(value, spatial_shapes, loc, attn)
    return torch.ops.snipper_tpu_torch.msda_forward(
        value, flat_shapes(spatial_shapes), loc, attn)


ms_deform_attn.launches = 0
ms_deform_attn.backward_launches = 0
ms_deform_attn.launches_by_dtype = {"f32": 0, "bf16": 0}
ms_deform_attn.backward_launches_by_dtype = {"f32": 0, "bf16": 0}
