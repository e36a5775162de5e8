"""Time the kernels of ``ops/csrc/win2d.cu`` against another version of
that source on one card, in turns: other, this, this, other.

    git show <commit>:snipper_tpu_torch/ops/csrc/win2d.cu > OTHER.cu
    python -m snipper_tpu_torch.scripts.win2d_ab OTHER.cu

The other source must keep the C interface (``win2d_sample_{f32,bf16}``,
``win2d_contract_f32``, ``hier_gather_f32``); it is built with the port's
nvcc flags into ``_build/libwin2d_other.so``. Both libraries are driven
through the same wrappers of ``ops/win2d.py`` on the same inputs: the
sampling probe's encoder fixture for ``win2d_sample`` (one op call, three
launches, bf16 and f32 value) and the lane-gather probe's four
kernel-only fixtures for ``win2d_contract`` and ``hier_gather``. Each turn
prints the time per call (CUDA events, median of 20, the wrapper's host
time included) and the device time alone (torch.profiler, every kernel of
10 calls), and how far the two libraries' outputs differ; each build
prints ptxas's registers and spills. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from snipper_tpu_torch.ops import _build, win2d


def build_other(source: Path):
    """Build ``source`` into ``_build/libwin2d_other.so``; returns the
    loaded library (with the wrappers' signatures) and nvcc's log."""
    out = _build.BUILD_DIR / "libwin2d_other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(out), str(source)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in win2d._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, log


def print_ptxas(tag, log):
    for line in log.splitlines():
        if "Compiling entry function" in line or "registers" in line \
                or "spill" in line:
            print(f"  [{tag}] {line.strip()}")


@contextlib.contextmanager
def using(lib):
    """The wrappers of ``ops/win2d.py`` launch from ``lib``."""
    saved = win2d._lib
    win2d._lib = lambda: lib
    try:
        yield
    finally:
        win2d._lib = saved


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=10):
    """Device time of every kernel ``fn`` launches, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def turns(label, fn, libs):
    """``fn`` from each library in turns other, this, this, other."""
    outs, res = {}, {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        with using(libs[tag]):
            outs[tag] = fn()
            res[tag].append((time_ms(fn), device_ms(fn)))
    first = outs["this"]
    first = first[0] if isinstance(first, list) else first
    other = outs["other"]
    other = other[0] if isinstance(other, list) else other
    diff = (first.float() - other.float()).abs().max().item()
    for tag in ("other", "this"):
        print(f"{label} [{tag}]: per call "
              + " / ".join(f"{m:.4f}" for m, _ in res[tag])
              + " ms, device "
              + " / ".join(f"{d:.4f}" for _, d in res[tag]) + " ms",
              flush=True)
    ratio = (statistics.mean(d for _, d in res["other"])
             / statistics.mean(d for _, d in res["this"]))
    print(f"{label}: other/this device time {ratio:.2f}x; outputs differ by "
          f"{diff:.3e}", flush=True)
    return res


def main(argv=None) -> int:
    from snipper_tpu_torch.ops.deform_attn import windowed2d_plan
    from snipper_tpu_torch.scripts import lanegather_probe, probe

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="another version of win2d.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("win2d_ab: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    this = _build.build("win2d.cu", "libwin2d.so")
    other, other_log = build_other(args.other)
    print_ptxas("this", this["log"])
    print_ptxas("other", other_log)
    libs = {"this": win2d._lib(), "other": other}
    torch.backends.cuda.matmul.allow_tf32 = False

    value, shapes, loc, attn = probe.encoder_inputs(max_off_px=4.0,
                                                    device="cuda")
    blocks, wins = windowed2d_plan(shapes, 8, 20, 5)
    taps, q0 = [], 0
    for si, (h, w) in enumerate(shapes):
        taps.append(win2d.segment_taps(
            shapes, loc[:, q0:q0 + h * w], attn[:, q0:q0 + h * w],
            shapes[si], blocks[si], wins[si]))
        q0 += h * w
    for v in (value, value.float()):
        turns(f"win2d_sample encoder {str(v.dtype)[6:]}, per op call "
              f"(3 launches)",
              lambda: [win2d.win2d_sample_cuda(v, shapes, t) for t in taps],
              libs)
    del value, loc, attn, taps
    for NB, C, widths in lanegather_probe.HIER_FIXTURES:
        wins, winsT, ids, idsT, wgts, wgtsT, _ = lanegather_probe._fixture(
            NB, C, widths, device="cuda")
        label = f"NB={NB} C={C} widths={widths}"
        turns(f"win2d_contract {label}",
              lambda: win2d.win2d_contract_cuda(wins, ids, wgts), libs)
        turns(f"hier_gather {label}",
              lambda: win2d.hier_gather_cuda(winsT, idsT, wgtsT), libs)
        del wins, winsT, ids, idsT, wgts, wgtsT
        torch.cuda.empty_cache()
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
