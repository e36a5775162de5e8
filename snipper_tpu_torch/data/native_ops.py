"""The host ops of the data and eval paths: the port's counterpart of
``snipper_tpu/data/native_ops.py``.

``warp_patch`` (the datasets' fused flip + bilinear warp + /255 + colour
scale + clip), ``warp_patch_exact`` (serving's warp, bit-equal to the
numpy ``generate_patch_image``) and ``lsa``/``lsa_pairs`` (the eval
harness's assignment) run in the port's own C++
(``data/csrc/imageops.cpp``, a plain C interface), which the host C++
compiler builds into ``snipper_tpu_torch/_build/`` at first use
(``ops/_build.py::build_host``) and ``ctypes`` loads. ``ctypes`` releases
the GIL for the call, so the loader's warp threads run side by side.

As the JAX package falls back when its extension is absent, the port falls
back to numpy (the warp) and scipy (the assignment) only when no C++
compiler is found, and then warns once. A compiler that fails to build the
source, or a library that fails to load, raises.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from pathlib import Path

import numpy as np

from snipper_tpu_torch.data.transforms import (_invert_affine,
                                               generate_patch_image)

SOURCE = Path(__file__).resolve().parent / "csrc" / "imageops.cpp"
_SINGULAR, _BAD_SHAPE = -1, -2

_lib = None            # the loaded library; False: no compiler, numpy
_lock = threading.Lock()
build_info: dict = {}  # the build's compiler command, seconds and path


def _open():
    """Build (if needed) and load the library; False without a compiler."""
    from snipper_tpu_torch.ops import _build

    compiler = _build.find_cxx()
    if compiler is None:
        warnings.warn(
            "snipper_tpu_torch.data.native_ops: no C++ compiler ($CXX, c++ "
            "or g++) found, so the host warp runs in numpy and the "
            "assignment in scipy", RuntimeWarning, stacklevel=3)
        return False
    res = _build.build_host(SOURCE, "libimageops.so", compiler)
    lib = ctypes.CDLL(str(res["path"]))

    def array(dtype, ndim):  # checks dtype, rank and contiguity per call
        return np.ctypeslib.ndpointer(dtype, ndim=ndim, flags="C_CONTIGUOUS")

    f64, i32, f32 = array(np.float64, 2), ctypes.c_int, ctypes.c_float
    lib.snipper_warp_affine.argtypes = [
        array(np.uint8, 3), i32, i32, f64, i32, i32, i32, f32, f32, f32,
        array(np.float32, 3)]
    lib.snipper_warp_affine.restype = i32
    lib.snipper_warp_patch_exact.argtypes = [
        array(np.uint8, 4), i32, i32, i32, f64, i32, i32,
        array(np.float32, 4)]
    lib.snipper_warp_patch_exact.restype = i32
    lib.snipper_lsa.argtypes = [f64, i32, i32, array(np.int64, 1)]
    lib.snipper_lsa.restype = i32
    build_info.update(command=res["command"], seconds=res["seconds"],
                      path=str(res["path"]))
    return lib


def _load():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _open()
    return _lib


def have_native() -> bool:
    """True when the host ops run in C++ (builds them at the first call)."""
    return bool(_load())


def warp_patch(img: np.ndarray, trans: np.ndarray, out_shape,
               do_flip: bool = False,
               color_scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Fused flip + bilinear warp + /255 + per-channel color scale + clip.
    ``img`` uint8 [H, W, 3]; returns float32 [out_h, out_w, 3]."""
    lib = _load()
    out_h, out_w = (int(v) for v in out_shape)
    if not lib:
        patch = generate_patch_image(img, do_flip, trans, out_shape)
        for c in range(3):
            patch[:, :, c] = np.clip(patch[:, :, c] * color_scale[c], 0, 1)
        return patch.astype(np.float32)
    src = np.ascontiguousarray(img, np.uint8)
    m = np.ascontiguousarray(trans, np.float64)
    if src.ndim != 3 or src.shape[2] != 3 or m.shape != (2, 3):
        raise ValueError(f"src must be [H,W,3], M [2,3] (got "
                         f"{src.shape}, {m.shape})")
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.snipper_warp_affine(
        src, src.shape[0], src.shape[1], m, out_h, out_w, int(do_flip),
        float(color_scale[0]), float(color_scale[1]), float(color_scale[2]),
        out)
    if rc == _SINGULAR:
        raise ValueError("singular affine matrix")
    if rc:
        raise ValueError(f"warp_patch: bad shapes {src.shape} -> "
                         f"{(out_h, out_w)}")
    return out


def warp_patch_exact(img: np.ndarray, trans: np.ndarray,
                     out_shape) -> np.ndarray:
    """``generate_patch_image(img, False, trans, out_shape)`` as float32,
    bit for bit, for one frame or a stack of frames warped by the same
    affine in one call: the bilinear zero-border warp by the forward
    affine ``trans`` and /255, with no flip, colour scale or clip.
    ``img`` uint8 [..., H, W, 3]; returns float32 [..., out_h, out_w, 3]."""
    out_h, out_w = (int(v) for v in out_shape)
    if img.dtype != np.uint8 or img.ndim < 3 or img.shape[-1] != 3:
        raise ValueError(f"img must be uint8 [..., H, W, 3] (got "
                         f"{img.dtype} {img.shape})")
    out = np.empty(img.shape[:-3] + (out_h, out_w, 3), np.float32)
    frames = np.ascontiguousarray(img).reshape(-1, *img.shape[-3:])
    outs = out.reshape(-1, out_h, out_w, 3)
    lib = _load()
    if not lib:
        for f, o in zip(frames, outs):
            o[...] = generate_patch_image(f, False, trans, (out_h, out_w))
        return out
    minv = np.ascontiguousarray(_invert_affine(np.asarray(trans, np.float64)))
    if lib.snipper_warp_patch_exact(frames, *frames.shape[:3], minv, out_h,
                                    out_w, outs):
        raise ValueError(f"warp_patch_exact: bad shapes {img.shape} -> "
                         f"{(out_h, out_w)}")
    return out


def lsa(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment of each row to a distinct column (rows <= cols);
    returns col index per row."""
    lib = _load()
    if not lib:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(cost)
        out = np.zeros(cost.shape[0], np.int64)
        out[rows] = cols
        return out
    c = np.ascontiguousarray(cost, np.float64)
    m, n = c.shape
    out = np.empty(m, np.int64)
    if lib.snipper_lsa(c, m, n, out) == _BAD_SHAPE:
        raise ValueError(f"lsa: need rows <= cols (got {c.shape})")
    return out


def lsa_pairs(cost: np.ndarray):
    """``scipy.optimize.linear_sum_assignment``-compatible optimal pairs
    ``(rows, cols)`` for an arbitrary ``[m, n]`` cost: the C++ assignment
    on the narrow side (transposed when ``m > n``), scipy where no compiler
    was found. The pairs come in row order for ``m <= n`` and column order
    otherwise; the assignment is optimal either way."""
    cost = np.asarray(cost, np.float64)
    m, n = cost.shape
    if m == 0 or n == 0:
        z = np.zeros(0, np.int64)
        return z, z
    if m <= n:
        return np.arange(m, dtype=np.int64), lsa(cost)
    rows = lsa(np.ascontiguousarray(cost.T))
    return rows, np.arange(n, dtype=np.int64)
