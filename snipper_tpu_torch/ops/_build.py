"""Builds the port's native code at first use and loads it with ctypes.

Each source under ``ops/csrc/`` has a plain C interface, so ``nvcc``
compiles it in seconds into a shared library under
``snipper_tpu_torch/_build/`` (listed in ``.gitignore``); no PyTorch
headers are involved. A library is rebuilt when its source, or a header
the source includes from ``ops/csrc/`` (``#include "..."``, followed
through headers), is newer. The build writes to a temporary name and
renames, so a process that reads the library never sees half of it.

The host ops (``data/csrc/imageops.cpp``) follow the same rules with the
host C++ compiler (:func:`build_host`). Their flags hold ``-march=native``,
so the library's name carries a digest of the compiler, the flags and the
host's CPU: a build directory copied to another machine is not reused
there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
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
# the flags of the JAX package's extension (native/setup.py), no fast-math
CXX_FLAGS = ("-O3", "-std=c++17", "-march=native", "-shared", "-fPIC")

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


def find_cxx():
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH;
    None when there is none."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        path = name and shutil.which(name)
        if path:
            return path
    return None


def dependencies(source) -> list:
    """``source`` (a name under ``ops/csrc/``, or a path) and every header
    it includes from its own directory with ``#include "..."``, directly or
    through other headers."""
    src = CSRC / source
    seen, todo = [src], [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            header = src.parent / name
            if header.exists() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def _compile(find_compiler, flags, src: Path, out: Path) -> dict:
    """Compile ``src`` into ``out`` with the compiler ``find_compiler()``
    names unless ``out`` is newer than ``src`` and every header it
    includes; the library is written under a temporary name and renamed,
    so a reader never loads half of it."""
    newest = max(p.stat().st_mtime for p in dependencies(src))
    if out.exists() and out.stat().st_mtime >= newest:
        return {"path": out, "seconds": 0.0, "log": ""}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    compiler = find_compiler()
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{os.path.basename(compiler)} failed "
                           f"({proc.returncode}) building {src}:\n{log}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


def build(source: str, lib_name: str) -> dict:
    """Compile ``ops/csrc/<source>`` with nvcc into ``_build/<lib_name>`` if
    it is missing or older than its source or a header the source includes
    (:func:`dependencies`). Returns ``{"path", "seconds", "log"}``;
    ``log`` holds nvcc's output (ptxas register and spill counts), empty
    when the library was already current."""
    return _compile(find_nvcc, NVCC_FLAGS, CSRC / source,
                    BUILD_DIR / lib_name)


def host_tag(compiler: str) -> str:
    """A digest of the compiler, :data:`CXX_FLAGS` and this host's CPU,
    which ``-march=native`` compiles for."""
    cpu = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            cpu += "".join(sorted({ln for ln in f if ln.startswith(
                ("model name", "flags"))}))
    except OSError:
        cpu += platform.processor()
    key = "\0".join((compiler, *CXX_FLAGS, cpu))
    return hashlib.sha1(key.encode()).hexdigest()[:12]


def build_host(source, lib_name: str, compiler: str) -> dict:
    """Compile the C++ file ``source`` (a path) with the host compiler
    ``compiler`` and :data:`CXX_FLAGS` into ``_build/<stem>-<tag>.so``
    (``lib_name``'s stem, :func:`host_tag`), under the same rules as
    :func:`build`. Returns ``{"path", "seconds", "log", "command"}``."""
    out = BUILD_DIR / f"{Path(lib_name).stem}-{host_tag(compiler)}.so"
    res = _compile(lambda: compiler, CXX_FLAGS, Path(source), out)
    res["command"] = " ".join([os.path.basename(compiler), *CXX_FLAGS])
    return res


def load(source: str, lib_name: str) -> ctypes.CDLL:
    """Build if needed, then load the library (one build at a time)."""
    with _lock:
        return ctypes.CDLL(str(build(source, lib_name)["path"]))
