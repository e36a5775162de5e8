"""Time the probe kernels of ``ops/csrc/win2d.cu`` and ``ops/csrc/lane_chain.cu``,
and the MSDA backward of ``ops/csrc/msda_backward.cu``, against other
versions of those sources on one card, in turns: other, this, this, other.

    git show <commit>:snipper_tpu_torch/ops/csrc/win2d.cu > OTHER_win2d.cu
    git show <commit>:snipper_tpu_torch/ops/csrc/lane_chain.cu > OTHER_lc.cu
    mkdir OTHER && git archive <commit> snipper_tpu_torch/ops/csrc \\
        | tar -x -C OTHER
    python -m snipper_tpu_torch.scripts.kernel_ab --win2d OTHER_win2d.cu \\
        --lane_chain OTHER_lc.cu \\
        --msda_backward OTHER/snipper_tpu_torch/ops/csrc/msda_backward.cu

Any of the sources may be given alone. ``--msda_backward`` takes a source
with the atomic backward's C interface (seven pointers: value, loc, attn,
grad_out, an f32 d_value the caller zeroes, d_loc, d_attn), taken beside
the ``msda_common.cuh`` it was written against (a quoted include is found
beside the including source before the port's own), run as its op
ran it: the zero fill, the kernel and, for a bf16 value, the cast; this
source runs as ``ops/msda.py``'s op runs it. Both at the train b8 shapes in
bf16 (encoder N = 32, Lq = S = 9875; decoder N = 48, Lq = 60; H = 8, D = 48,
L = 3, P = 4) and the train b2 shapes in f32 (N = 8 and 12), each with its
bound (``msda_backward_bound_ms``); the outputs are compared, and this
version's d_value of two calls must be bitwise equal (exit 1 otherwise).
The other source must keep the C interface (``win2d_sample_{f32,bf16}``,
``win2d_contract_f32`` and ``hier_gather_f32``; ``chain_gather_f32`` and
``chain_select_f32``); it is built with the port's nvcc flags into
``_build/lib<name>_other.so``. Both
libraries are driven through the same wrappers (``ops/win2d.py``,
``ops/lane_chain.py``) on the same inputs: the sampling probe's encoder
fixture for ``win2d_sample`` (one op call, three launches, bf16 and f32
value), the lane-gather probe's four kernel-only fixtures for
``win2d_contract`` and ``hier_gather``, and its 64 x [512, 128], n = 64 for
the two chains, whose outputs must be bitwise equal to each other and to
the plain chain. Each turn prints the time per call (CUDA events, median
of 20, the wrapper's host time included) and the device time alone
(torch.profiler, every kernel of 10 calls), and how far the two libraries'
outputs differ; each build prints ptxas's registers and spills, and for
the chains each kernel's count of shuffle, compare, select and add
instructions in its machine code (``cuobjdump -sass``). Exits 1 if the
chains differ. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from snipper_tpu_torch.ops import _build, lane_chain, win2d


def build_other(source: Path, stem: str, signatures):
    """Build ``source`` into ``_build/lib<stem>_other.so``; returns the
    loaded library (with ``signatures``), its path and nvcc's log."""
    out = _build.BUILD_DIR / f"lib{stem}_other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(out), str(source)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, out, log


def print_ptxas(tag, log):
    for line in log.splitlines():
        if "Compiling entry function" in line or "registers" in line \
                or "spill" in line:
            print(f"  [{tag}] {line.strip()}")


SASS_OPS = ("SHFL", "ISETP", "FSEL", "SEL", "FADD", "LDG", "STG", "BRA")


def sass_counts(lib_path) -> dict:
    """Per kernel of ``lib_path``: how many of its machine instructions
    (``cuobjdump -sass``, static, the unrolled loop counted once) have
    each opcode of ``SASS_OPS``, and ``all`` of them. Empty where the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     line)
        if m and cur is not None:
            cur["all"] += 1
            if m.group(1) in SASS_OPS:
                cur[m.group(1)] += 1
    return out


def print_sass(tag, lib_path):
    for kernel, counts in sass_counts(lib_path).items():
        print(f"  [{tag}] sass {kernel}: " + ", ".join(
            f"{op} {counts[op]}" for op in ("all",) + SASS_OPS))


@contextlib.contextmanager
def using(module, lib):
    """The wrappers of ``module`` launch from ``lib``."""
    saved = module._lib
    module._lib = lambda: lib
    try:
        yield
    finally:
        module._lib = saved


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


def device_ms(fn, reps=10, tries=3):
    """Device time of every kernel ``fn`` launches, per call. A profile
    that recorded no device time (the profiler dropped its events) is
    taken again; after ``tries`` it raises rather than report 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} "
                       f"profiles")


def kernel_ms(fn, reps=10):
    """Device time per call of each kernel ``fn`` launches, by name
    (torch.profiler, ``reps`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def turns(label, fn, module, libs):
    """``fn`` from each library in turns other, this, this, other; returns
    the two libraries' outputs."""
    outs, res = {}, {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        with using(module, libs[tag]):
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
    return first, other


def ab_win2d(other_src: Path):
    from snipper_tpu_torch.ops.deform_attn import windowed2d_plan
    from snipper_tpu_torch.scripts import lanegather_probe, probe

    this = _build.build("win2d.cu", "libwin2d.so")
    other, _, other_log = build_other(other_src, "win2d", win2d._SIGNATURES)
    print_ptxas("this", this["log"])
    print_ptxas("other", other_log)
    libs = {"this": win2d._lib(), "other": other}

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
              win2d, libs)
    del value, loc, attn, taps
    for NB, C, widths in lanegather_probe.HIER_FIXTURES:
        wins, winsT, ids, idsT, wgts, wgtsT, _ = lanegather_probe._fixture(
            NB, C, widths, device="cuda")
        label = f"NB={NB} C={C} widths={widths}"
        turns(f"win2d_contract {label}",
              lambda: win2d.win2d_contract_cuda(wins, ids, wgts), win2d, libs)
        turns(f"hier_gather {label}",
              lambda: win2d.hier_gather_cuda(winsT, idsT, wgtsT), win2d, libs)
        del wins, winsT, ids, idsT, wgts, wgtsT
        torch.cuda.empty_cache()


MSDA_SHAPES = [(75, 100), (38, 50), (19, 25)]  # 600x800 at strides 8/16/32
# (name, N, Lq, queries on the pixel grid, value dtype): canonical_t4_f2 at
# batch 8 in bf16 (the benchmark's training) and at batch 2 in f32
# (--deform_dtype float32)
MSDA_BACKWARD_CASES = (
    ("train_b8_encoder", 32, 9875, True, torch.bfloat16),
    ("train_b8_decoder", 48, 60, False, torch.bfloat16),
    ("train_b2_encoder", 8, 9875, True, torch.float32),
    ("train_b2_decoder", 12, 60, False, torch.float32))
# H100 SXM: HBM3 bytes per second and dense f32 operations per second
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def msda_backward_bound_ms(N, Lq, S, H, D, L, P, esize):
    """Least time of one backward call: value rows (at most four per tap,
    at most all of them), grad_out, loc and attn read once, d_value (in
    the value's type, whole), d_loc and d_attn written once, over the HBM
    rate; per tap and channel 8 multiply-adds (the four corner dots and
    the four corner products), plus ~30 per tap, over the f32 rate."""
    taps = N * Lq * H * L * P
    rows = min(N * S * H, 4 * taps)
    nbytes = ((rows + N * Lq * H + N * S * H) * D * esize
              + taps * 2 * (8 + 4))
    ops = taps * (16 * D + 30)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3


def msda_backward_inputs(N, Lq, grid, seed, dtype, H=8, D=48, P=4,
                         off_px=4.0):
    """value and grad_out in ``dtype``, f32 loc and attn on the card:
    ``chip_smoke.py``'s ``msda_inputs`` (grid queries with offsets of up to
    ``off_px`` pixels, else uniform in [-0.1, 1.1])."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = MSDA_SHAPES
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = torch.randn(N, S, H, D, device="cuda", generator=g)
    if grid:
        refs = []
        for h, w in shapes:
            gy, gx = torch.meshgrid(
                (torch.arange(h, device="cuda") + 0.5) / h,
                (torch.arange(w, device="cuda") + 0.5) / w, indexing="ij")
            refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        ref = torch.cat(refs, 0)[:Lq]
        norm = torch.tensor([[w, h] for h, w in shapes], device="cuda",
                            dtype=torch.float32)
        off = (torch.rand(N, Lq, H, L, P, 2, device="cuda", generator=g)
               * 2 - 1) * off_px
        loc = ref[None, :, None, None, None, :] + off / norm[:, None, :]
    else:
        loc = torch.rand(N, Lq, H, L, P, 2, device="cuda",
                         generator=g) * 1.2 - 0.1
    logits = torch.randn(N, Lq, H, L * P, device="cuda", generator=g)
    attn = (torch.softmax(logits, -1) / 3).reshape(N, Lq, H, L, P)
    grad_out = torch.randn(N, Lq, H * D, device="cuda", generator=g)
    return (value.to(dtype), shapes, loc.contiguous(), attn.contiguous(),
            grad_out.to(dtype))


def ab_msda_backward(other_src: Path) -> bool:
    """The other backward (fill, atomic kernel, cast) against this one, in
    turns; True if this version's d_value is bitwise equal over calls."""
    from snipper_tpu_torch.ops import msda

    this = _build.build("msda_backward.cu", "libmsda_backward.so")
    sig = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 5 + [ctypes.c_int] * 2
           + [ctypes.c_void_p] * 3)
    other, _, other_log = build_other(
        other_src, "msda_backward",
        {"msda_backward_f32": sig, "msda_backward_bf16": sig})
    print_ptxas("this", this["log"])
    print_ptxas("other", other_log)
    ok = True
    for i, (name, N, Lq, grid, dtype) in enumerate(MSDA_BACKWARD_CASES):
        value, shapes, loc, attn, grad_out = msda_backward_inputs(
            N, Lq, grid, 30 + i, dtype)
        kind = "f32" if dtype == torch.float32 else "bf16"
        _, S, H, D = value.shape
        L, P = loc.shape[3], loc.shape[4]
        shapes_c, starts_c = msda._level_table(shapes)

        def run_other():
            d_value = torch.zeros(N, S, H, D, dtype=torch.float32,
                                  device="cuda")
            d_loc = torch.empty_like(loc)
            d_attn = torch.empty_like(attn)
            err = getattr(other, f"msda_backward_{kind}")(
                value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                grad_out.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
                d_attn.data_ptr(), N, S, H, D, Lq, L, P,
                ctypes.cast(shapes_c, ctypes.c_void_p),
                ctypes.cast(starts_c, ctypes.c_void_p),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"other msda_backward: CUDA error {err}")
            return d_value.to(dtype), d_loc, d_attn

        def run_this():
            return msda.msda_backward(value, shapes, loc, attn, grad_out)

        fns = {"other": run_other, "this": run_this}
        outs, res = {}, {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            outs.setdefault(tag, []).append(fns[tag]())
            res[tag].append((time_ms(fns[tag]), device_ms(fns[tag])))
        torch.cuda.synchronize()
        bound = msda_backward_bound_ms(N, Lq, S, H, D, L, P,
                                       value.element_size())
        label = (f"msda_backward {name} {kind} (N={N} Lq={Lq} S={S} H={H} "
                 f"D={D} L={L} P={P})")
        for tag in ("other", "this"):
            print(f"{label} [{tag}]: per call "
                  + " / ".join(f"{m:.4f}" for m, _ in res[tag])
                  + " ms, device "
                  + " / ".join(f"{d:.4f}" for _, d in res[tag])
                  + f" ms; bound {bound:.4f} ms", flush=True)
        dev = {tag: statistics.mean(d for _, d in res[tag]) for tag in res}
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(outs["this"][0], outs["other"][0])]
        same = torch.equal(outs["this"][0][0], outs["this"][1][0])
        print(f"{name}: other/this device time "
              f"{dev['other'] / dev['this']:.2f}x ({dev['other']:.4f} / "
              f"{dev['this']:.4f} ms, bound {bound:.4f} ms); d_value, d_loc, "
              f"d_attn differ by " + ", ".join(f"{d:.3e}" for d in diffs)
              + f"; this d_value bitwise equal over calls: {same}",
              flush=True)
        for tag in ("other", "this"):
            for kname, ms in sorted(kernel_ms(fns[tag]).items(),
                                    key=lambda kv: -kv[1]):
                print(f"  [{tag}] {ms:.4f} ms {kname[:110]}", flush=True)
        ok = ok and same
        del value, loc, attn, grad_out, outs
        torch.cuda.empty_cache()
    return ok


def ab_lane_chain(other_src: Path) -> bool:
    """Both chains in turns; True if every output is bitwise equal to the
    plain chain."""
    this = _build.build("lane_chain.cu", "liblane_chain.so")
    other, other_path, other_log = build_other(other_src, "lane_chain",
                                               lane_chain._SIGNATURES)
    print_ptxas("this", this["log"])
    print_ptxas("other", other_log)
    print_sass("this", this["path"])
    print_sass("other", other_path)
    libs = {"this": lane_chain._lib(), "other": other}
    g = torch.Generator(device="cuda").manual_seed(40)
    x = torch.randn(64, 512, 128, device="cuda", generator=g)
    idx = torch.randint(0, 128, (64, 512, 128), device="cuda", generator=g,
                        dtype=torch.int32)
    n, ok = 64, True
    for name in ("chain_gather", "chain_select"):
        fn = getattr(lane_chain, f"{name}_cuda")
        got, got_other = turns(f"{name} 64x[512,128] n={n}",
                               lambda: fn(x, idx, n), lane_chain, libs)
        want = getattr(lane_chain, f"{name}_torch")(x, idx, n)
        same = torch.equal(got, want) and torch.equal(got_other, want)
        print(f"{name}: both libraries bitwise equal to the plain chain: "
              f"{same}", flush=True)
        ok = ok and same
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--win2d", type=Path, help="another version of win2d.cu")
    ap.add_argument("--lane_chain", type=Path,
                    help="another version of lane_chain.cu")
    ap.add_argument("--msda_backward", type=Path,
                    help="another version of msda_backward.cu (the atomic "
                         "backward's C interface)")
    args = ap.parse_args(argv)
    if args.win2d is None and args.lane_chain is None \
            and args.msda_backward is None:
        ap.error("give --win2d, --lane_chain, --msda_backward or several")
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    if args.lane_chain is not None:
        ok = ab_lane_chain(args.lane_chain)
    if args.win2d is not None:
        ab_win2d(args.win2d)
    if args.msda_backward is not None:
        ok = ab_msda_backward(args.msda_backward) and ok
    print("DONE" if ok else "FAIL: a chain or a d_value is not bitwise "
          "equal", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
