"""Dependent in-row gather and select chains: the wrappers of the CUDA
kernels ``chain_gather`` and ``chain_select`` (``ops/csrc/lane_chain.cu``),
each beside its plain PyTorch version.

They replace ``probe_primitive``'s Pallas kernels ``_chain_gather_kernel``
and ``_chain_select_kernel`` (``scripts/lanegather_probe.py:69-127``), which
time a chain of ``n`` in-tile lane gathers against ``n`` compare + select +
add steps over rows of 128 f32 values. Each wrapper chooses by device:
CPU tensors take the plain version, CUDA tensors launch the kernel or the
wrapper raises. ``<wrapper>.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

ROW = 128  # the row width, the TPU's lane count
# x, idx, out, rows, n, stream
_SIGNATURES = {name: [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                              ctypes.c_void_p]
               for name in ("chain_gather_f32", "chain_select_f32")}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load ``liblane_chain.so``."""
    from snipper_tpu_torch.ops import _build

    lib = _build.load("lane_chain.cu", "liblane_chain.so")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def chain_gather_torch(x: torch.Tensor, idx: torch.Tensor,
                       n: int) -> torch.Tensor:
    """``n`` times ``x = x[..., idx] + 1`` along the last axis."""
    idx = idx.long()
    for _ in range(n):
        x = torch.gather(x, -1, idx) + 1.0
    return x


def chain_select_torch(x: torch.Tensor, idx: torch.Tensor,
                       n: int) -> torch.Tensor:
    """``n`` times ``x = x + where(idx == lane - (i % 2), x, 0)``, ``lane``
    the column index."""
    lane = torch.arange(x.shape[-1], device=x.device, dtype=idx.dtype)
    for i in range(n):
        x = x + torch.where(idx == lane - (i % 2), x, 0.0)
    return x


def _launch(name: str, x: torch.Tensor, idx: torch.Tensor,
            n: int) -> torch.Tensor:
    """Launch ``<name>_f32`` on ``x [..., 128]`` f32 and ``idx`` int32 of
    the same shape (values in ``[0, 128)``), both contiguous on one CUDA
    device. Raises on anything the kernel does not take."""
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError(f"{name}: x and idx must lie on one CUDA device "
                         f"(got {x.device}, {idx.device})")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"{name}: x must be float32 and idx int32 (got "
                        f"{x.dtype}, {idx.dtype})")
    if x.shape != idx.shape or x.shape[-1] != ROW or n < 0:
        raise ValueError(f"{name}: x and idx must share a [..., {ROW}] shape "
                         f"and n >= 0 (got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}, n={n})")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: x and idx must be contiguous")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), f"{name}_f32")(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.numel() // ROW,
            n, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def chain_gather_cuda(x: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Launch ``chain_gather``: one warp per row on a resident grid, 16
    warp shuffles per step."""
    out = _launch("chain_gather", x, idx, n)
    chain_gather.launches += 1
    return out


def chain_select_cuda(x: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Launch ``chain_select``: one warp per row on a resident grid,
    compare + select + add per element and step."""
    out = _launch("chain_select", x, idx, n)
    chain_select.launches += 1
    return out


def chain_gather(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The gather chain: the plain version for CPU tensors, the kernel for
    CUDA ones."""
    if x.device.type == "cpu":
        return chain_gather_torch(x, idx, n)
    return chain_gather_cuda(x, idx, n)


def chain_select(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The select chain: the plain version for CPU tensors, the kernel for
    CUDA ones."""
    if x.device.type == "cpu":
        return chain_select_torch(x, idx, n)
    return chain_select_cuda(x, idx, n)


chain_gather.launches = 0
chain_select.launches = 0
