"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source under ``ops/csrc/`` has a plain C interface, so ``nvcc``
compiles it in seconds into a shared library under
``snipper_tpu_torch/_build/`` (listed in ``.gitignore``); no PyTorch
headers are involved. A library is rebuilt when its source, or a header
the source includes from ``ops/csrc/`` (``#include "..."``, followed
through headers), is newer. The build writes to a temporary name and
renames, so a process that reads the library never sees half of it.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "ops" / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        if os.path.exists(os.path.join(home, "bin", "nvcc")):
            nvcc = os.path.join(home, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit (nvcc on PATH or in "
            "$CUDA_HOME/bin)")
    return nvcc


def dependencies(source: str) -> list:
    """``ops/csrc/<source>`` and every header it includes from ``ops/csrc/``
    with ``#include "..."``, directly or through other headers."""
    seen, todo = [CSRC / source], [CSRC / source]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            header = CSRC / name
            if header.exists() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def build(source: str, lib_name: str) -> dict:
    """Compile ``ops/csrc/<source>`` into ``_build/<lib_name>`` if it is
    missing or older than its source or a header the source includes
    (:func:`dependencies`). Returns ``{"path", "seconds", "log"}``;
    ``log`` holds nvcc's output (ptxas register and spill counts), empty
    when the library was already current."""
    src = CSRC / source
    out = BUILD_DIR / lib_name
    newest = max(p.stat().st_mtime for p in dependencies(source))
    if out.exists() and out.stat().st_mtime >= newest:
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src}:\n{log}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


def load(source: str, lib_name: str) -> ctypes.CDLL:
    """Build if needed, then load the library (one build at a time)."""
    with _lock:
        return ctypes.CDLL(str(build(source, lib_name)["path"]))
