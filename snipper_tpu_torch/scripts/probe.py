"""Probes on the card: the port of ``scripts/probe.py``. ``forward``,
``train`` and ``split`` time the model's forward per preset, the training
step and the forward without the sampling; ``op`` and ``lanegather`` time
the sampling formulations and the TPU kernels' questions at the JAX
probe's own sizes; ``serve`` and ``fast`` time the serving artifact
against the live forward and the ``--fast`` profiles; ``meshscale`` times
data-parallel serving over N ranks.

    python -m snipper_tpu_torch.scripts.probe forward \\
        [--presets canonical_t4,light_t1] [--batch 1,4] [--dtype f32]
    python -m snipper_tpu_torch.scripts.probe train [--mp both] [-K 4]
    python -m snipper_tpu_torch.scripts.probe split [--preset canonical_t4]
    python -m snipper_tpu_torch.scripts.probe op \\
        --impls windowed,windowed2d,windowed2d_pallas,pmerged,pallas,core
    python -m snipper_tpu_torch.scripts.probe lanegather
    python -m snipper_tpu_torch.scripts.probe serve [--preset canonical_t4]
    python -m snipper_tpu_torch.scripts.probe fast [--specs "base|enc4,p2"]
    python -m snipper_tpu_torch.scripts.probe meshscale [--preset light_t4]

Each prints the JAX probe's lines with the card's times, then ``DONE``.
``op`` samples at encoder scale (canonical 600x800 level shapes, 4 folded
frames, 8 heads of 48 channels, 4 points, bf16 value) and keeps the JAX
probe's impl names, so that a TPU line and an H100 line can be set side by
side. What each runs here:

  core                ``ms_deform_attn_torch`` (plain, ``grid_sample``)
  pallas              ``ms_deform_attn``: the ``msda_forward`` kernel
  pmerged, windowed,  plain PyTorch (``ops/deform_attn.py``)
  windowed2d
  windowed2d_pallas   ``ms_deform_attn_windowed2d_kernel``: the
                      ``win2d_sample`` kernel (``ops/win2d.py``)

``lanegather`` runs ``scripts/lanegather_probe.py``'s counterpart
(``lanegather_probe.run``). Timing is the JAX probe's method
(``scripts/probe.py:45-56``): K enqueued calls, best of ``repeats`` passes,
between two CUDA events where the JAX probe reads back a scalar (on the
CPU, the host clock). Like the JAX probe, an impl that raises prints a
``FAIL`` line and the sweep goes on; the probe then exits non-zero after
``DONE``. ``--device`` is ``cuda`` unless the CPU is asked for, and the
probe raises without a card.

``serve`` exports the preset's forward on bf16 weights (``infer/export.py``
with ``param_dtype="bfloat16"``, JAX's ``bf16_params``), loads the
artifact back and times it against the same forward run live, both on an
f32 input, as the JAX probe's ``serve`` does (``scripts/probe.py:
355-358``); it prints ms per snippet and their ratio, with the artifact's
size. ``fast`` seeds one model, casts its one state dict to bf16, maps it
to each profile of ``--specs`` (``infer/fast.py``) and prints each
profile's snippets/s on a bf16 input beside the base's, as the JAX
probe's ``fast`` (``:454-466``); a spec that raises prints ``FAIL`` and
the probe exits non-zero after ``DONE``.

``forward`` seeds each preset's model and a uniform input per batch and
prints the JAX probe's line (ms/snippet, snippets/s, overflow, shapes),
with ``impl=`` what ran: ``kernel`` (the ``msda_forward`` kernel),
``plain`` (the plain MSDA on the CPU) or ``skip`` (``--impl skip``: no
sampling). ``--dtype bf16`` is JAX's bf16 recipe, as in the JAX probe
(``scripts/probe.py:121-127``): the model's weights cast to bf16 once by
``models/snipper.py::bf16_params`` and a bf16 input; ``f32`` the forward
in f32; TF32 is off for both.
A preset that raises prints ``FAIL`` and the probe exits non-zero after
``DONE``. ``train`` builds the trainer's state and steps it over one
synthetic batch already on the device: the first step is timed apart
(the JAX line's ``compile``), then K steps by the host clock to the read
of the last loss; ``--profile_dir`` traces those K steps and prints the
top device ops (the line then says ``(traced)``). ``--impls`` and
``--remat`` go into the config as in the JAX probe: every impl but
``skip`` runs the exact kernel, and the port has no rematerialization.
``split`` times the bf16 forward (bf16 weights and input, the JAX
probe's ``:323-327``) with ``deform_impl="skip"`` at
(enc, dec) in {(6,6), (2,6), (6,2), (1,1)} and solves
``t = c0 + e*ce + d*cd`` by least squares.

``meshscale`` times the forward of a global batch of N snippets split
over N ranks, N in {1, 4, 8}, one rank per card (NCCL), or N gloo ranks
on the CPU with ``--device cpu`` (the CPU counts as one device unless
``--devices`` says more, and the ranks split its cores), and prints the
JAX probe's overhead efficiency ``eff(N) = t(1, b1) / (t(N, bN) / N)``
(1.0: the split adds no overhead). ``t(N, bN)`` is the slowest rank's
time per forward between two barriers. N larger than the devices prints
``n=N: skipped (k devices)``. Each rank must hold exactly B/N rows of the
global batch, disjoint from the others'.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import sys
import time
import traceback

import numpy as np
import torch


# ---------------------------------------------------------------- timing
def time_fn(fn, *args, K: int = 8, repeats: int = 2) -> float:
    """ms/call, best of ``repeats`` passes of K enqueued calls: CUDA events
    around the K calls when ``fn`` returns CUDA tensors, else the host
    clock."""
    out = fn(*args)            # build + warm
    first = out[0] if isinstance(out, (tuple, list)) else out
    best = float("inf")
    for _ in range(repeats):
        if first.is_cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(K):
                fn(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / K
        else:
            t0 = time.perf_counter()
            for _ in range(K):
                fn(*args)
            ms = (time.perf_counter() - t0) / K * 1e3
        best = min(best, ms)
    return best


# ------------------------------------------------------- shared fixtures
def encoder_inputs(seed: int = 0, max_off_px: float = 6.0, device="cuda"):
    """Encoder-scale sampling-op inputs, as ``scripts/probe.py:61-86`` makes
    them with numpy: canonical 600x800 level shapes, B_fold=4 (=batch*T),
    H=8, D=48, P=4, bf16 value, grid reference points + uniform random
    offsets <= max_off_px, f32 locations and weights."""
    rng = np.random.default_rng(seed)
    shapes = [(75, 100), (38, 50), (19, 25)]
    S = sum(h * w for h, w in shapes)
    B, H, D, P = 4, 8, 48, 4
    value = torch.from_numpy(rng.standard_normal((B, S, H, D))) \
        .to(torch.bfloat16)
    refs = []
    for (h, w) in shapes:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    ref = np.concatenate(refs, 0)
    off = rng.uniform(-max_off_px, max_off_px, (B, S, H, len(shapes), P, 2))
    norm = np.array([(w, h) for h, w in shapes], np.float64)
    loc = ref[None, :, None, None, None, :] + off / norm[None, None, None,
                                                         :, None, :]
    loc = torch.from_numpy(loc).float()
    attn = torch.from_numpy(
        rng.uniform(0, 1, (B, S, H, len(shapes), P))).float()
    attn = attn / attn.sum((-1, -2), keepdim=True)
    return value.to(device), shapes, loc.to(device), attn.to(device)


def make_cfg(preset: str, **over):
    from snipper_tpu_torch.config import Config

    cfg = getattr(Config, preset)()
    return cfg.replace(**over) if over else cfg


@contextlib.contextmanager
def tf32_off():
    """cuBLAS and cuDNN in true f32 for the block."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, prev):
            f.allow_tf32 = v


def _ran(cfg, device) -> str:
    """What the model's deformable sampling runs on ``device``."""
    if cfg.deform_impl == "skip":
        return "skip"
    return "kernel" if device.type == "cuda" else "plain"


# ---------------------------------------------------------- subcommands
def cmd_forward(args) -> int:
    """Per-preset inference throughput over batch sizes; returns the number
    of (preset, batch) points that failed."""
    from snipper_tpu_torch.models.snipper import bf16_model, resolve_device

    device = resolve_device(args.device)
    bf16 = args.dtype == "bf16"
    note = "bf16 weights and input" if bf16 else "f32"
    rng = np.random.default_rng(0)
    failed = 0
    with tf32_off():
        for preset in args.presets.split(","):
            for batch in (int(b) for b in args.batch.split(",")):
                try:
                    cfg = make_cfg(preset, deform_impl=args.impl)
                    model = _seeded_state(cfg, device)
                    x = torch.from_numpy(rng.uniform(
                        0, 1, (batch, cfg.num_frames, cfg.input_height,
                               cfg.input_width, 3)).astype(np.float32)
                    ).to(device)
                    if bf16:
                        bf16_model(model)
                        x = x.to(torch.bfloat16)
                    ovf = float(model(x)["sampling_overflow"])
                    ms = time_fn(lambda xx: model(xx)["pred_logits"], x,
                                 K=args.K)
                    del model
                    per = ms / batch
                    print(f"{preset:16s} b{batch}: {per:7.1f} ms/snippet "
                          f"({1e3 / per:6.2f} snippets/s) overflow={ovf} "
                          f"[{cfg.input_height}x{cfg.input_width} "
                          f"T={cfg.num_frames}+{cfg.num_future_frames} "
                          f"enc{cfg.enc_layers}/dec{cfg.dec_layers} "
                          f"impl={_ran(cfg, device)} {note}]", flush=True)
                except Exception as e:  # noqa: BLE001 - reported, counted
                    failed += 1
                    _fail(f"{preset} b{batch}", e)
    return failed


def cmd_train(args) -> int:
    """Train-step timing over impl x mixed precision: the first two steps
    apart (on one card the second captures the step as a CUDA graph,
    ``train/step.py``), then K steps; returns the number of runs that
    failed."""
    from snipper_tpu_torch.data.loader import DataLoader
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.models.snipper import build_model, resolve_device
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import batch_to_device, train_step

    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    mps = {"on": (True,), "off": (False,), "both": (False, True)}[args.mp]
    failed = 0
    for impl in args.impls.split(","):
        for mp in mps:
            try:
                cfg = make_cfg(args.preset, deform_impl=impl,
                               remat_policy=args.remat)
                model = build_model(cfg, device=device, seed=1)
                crit = SetCriterion(cfg)
                state = create_train_state(cfg, model, steps_per_epoch=100)
                dataset = SyntheticDataset(
                    cfg, n_samples=max(2, args.batch_size))
                loader = DataLoader(dataset, args.batch_size, shuffle=False)
                # a batch on the device: training overlaps the copy
                # (loader.device_prefetch), so the timing leaves it out
                batch = batch_to_device(next(iter(loader)), device)
                gen = torch.Generator().manual_seed(2)
                t0 = time.perf_counter()
                m = train_step(state, crit, batch, gen, mixed_precision=mp)
                loss0 = float(m["loss_total"])
                train_step(state, crit, batch, gen, mixed_precision=mp)
                sync()
                compile_s = time.perf_counter() - t0

                def steps():
                    t0 = time.perf_counter()
                    for _ in range(args.K):
                        m = train_step(state, crit, batch, gen,
                                       mixed_precision=mp)
                    loss1 = float(m["loss_total"])
                    ms = (time.perf_counter() - t0) / args.K * 1e3
                    return m, loss1, ms

                if args.profile_dir:
                    from snipper_tpu_torch.utils import profiling

                    with profiling.trace(args.profile_dir):
                        m, loss1, ms = steps()
                        sync()
                    top = profiling.summarize_trace(args.profile_dir,
                                                    top_k=20,
                                                    n_iters=args.K)
                    print(f"-- top device ops (ms/step, {impl} mp={mp}):")
                    for src, t_ms in top.items():
                        print(f"   {t_ms:8.2f}  {src}", flush=True)
                else:
                    m, loss1, ms = steps()
                ovf = float(m["sampling_overflow"])
                del state, model
                traced = " (traced)" if args.profile_dir else ""
                print(f"train {impl} mp={mp} remat={args.remat} "
                      f"b{args.batch_size}: {ms:.1f} ms/step{traced} "
                      f"(compile {compile_s:.0f}s, "
                      f"loss {loss0:.1f}->{loss1:.1f}, overflow {ovf})",
                      flush=True)
            except Exception as e:  # noqa: BLE001 - reported, counted
                failed += 1
                _fail(f"train {impl} mp={mp}", e)
    return failed


def cmd_split(args) -> int:
    """The forward without the sampling (``deform_impl="skip"``, bf16
    weights and input) at four (enc, dec) depths, and the least-squares
    split ``t = c0 + e*ce + d*cd``; returns 0 (a point that fails
    raises)."""
    from snipper_tpu_torch.models.snipper import bf16_model, resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    pts = []
    with tf32_off():
        for e, d in ((6, 6), (2, 6), (6, 2), (1, 1)):
            cfg = make_cfg(args.preset, deform_impl="skip", enc_layers=e,
                           dec_layers=d)
            model = bf16_model(_seeded_state(cfg, device))
            x = torch.from_numpy(rng.uniform(
                0, 1, (1, cfg.num_frames, cfg.input_height,
                       cfg.input_width, 3)).astype(np.float32)).to(
                           device, torch.bfloat16)
            ms = time_fn(lambda xx: model(xx)["pred_logits"], x, K=args.K)
            del model
            pts.append((e, d, ms))
            print(f"enc={e} dec={d}: {ms:7.2f} ms", flush=True)
    A = np.array([[1, e, d] for e, d, _ in pts], np.float64)
    y = np.array([ms for _, _, ms in pts])
    c0, ce, cd = np.linalg.lstsq(A, y, rcond=None)[0]
    print(f"solved: c0={c0:.2f} ms  ce={ce:.3f} ms/enc-layer  "
          f"cd={cd:.3f} ms/dec-layer", flush=True)
    return 0


def _op_fn(impl, value, shapes, segs, bc, margin):
    """``(fn(loc, attn), unpack)`` for one impl name of the sweep;
    ``unpack``: fn returns ``(out, overflow)``."""
    from snipper_tpu_torch.ops.deform_attn import (ms_deform_attn_pmerged,
                                                   ms_deform_attn_windowed,
                                                   ms_deform_attn_windowed2d)
    from snipper_tpu_torch.ops.msda import (ms_deform_attn,
                                            ms_deform_attn_torch)
    from snipper_tpu_torch.ops.win2d import ms_deform_attn_windowed2d_kernel

    part = functools.partial
    if impl == "core":
        return part(ms_deform_attn_torch, value, shapes), False
    if impl == "pmerged":
        return part(ms_deform_attn_pmerged, value, shapes,
                    query_chunk=bc), False
    if impl == "windowed":
        return part(ms_deform_attn_windowed, value, shapes,
                    query_segments=segs, base_chunk=bc,
                    margin_px=margin), True
    if impl == "windowed2d":
        return part(ms_deform_attn_windowed2d, value, shapes,
                    query_segments=segs, margin_px=margin), True
    if impl == "windowed2d_pallas":
        return part(ms_deform_attn_windowed2d_kernel, value, shapes,
                    query_segments=segs, margin_px=margin), True
    if impl == "pallas":
        return part(ms_deform_attn, value, shapes), False
    raise ValueError(f"unknown op impl {impl!r}")


def _fail(label, e):
    traceback.print_exc()
    print(f"{label}: FAIL {type(e).__name__}: {e}"[:160], flush=True)


def cmd_op(args) -> int:
    """Encoder-scale sampling-op timing over formulation, base chunk and
    margin; returns the number of impls that failed."""
    from snipper_tpu_torch.models.snipper import resolve_device
    from snipper_tpu_torch.ops.deform_attn import windowed_sampling_plan
    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch

    value, shapes, loc, attn = encoder_inputs(
        max_off_px=args.max_off_px, device=resolve_device(args.device))
    segs = tuple(h * w for h, w in shapes)
    ref = ms_deform_attn_torch(value, shapes, loc, attn).float()
    scale = ref.abs().max()

    def relerr(out):
        return ((out.float() - ref).abs().max() / scale).item()

    failed = 0
    for impl in args.impls.split(","):
        for bc in (int(b) for b in args.base_chunk.split(",")):
            for margin in (int(m) for m in args.margin.split(",")):
                label = f"{impl} bc={bc} m={margin}"
                try:
                    fn, unpack = _op_fn(impl, value, shapes, segs, bc, margin)
                    out = fn(loc, attn)
                    ovf = 0.0
                    if unpack:
                        out, ovf_t = out
                        ovf = float(ovf_t)
                    ms = time_fn(
                        lambda l, a: (fn(l, a)[0] if unpack else fn(l, a)),
                        loc, attn, K=args.K)
                    _, qcs, wins = windowed_sampling_plan(shapes, bc, margin)
                    print(f"{label:28s}: {ms:7.2f} ms/op-call  "
                          f"relerr {relerr(out):.2e} overflow={ovf} "
                          f"windows={wins if impl.startswith('win') else '-'}",
                          flush=True)
                except Exception as e:  # noqa: BLE001 - reported, counted
                    failed += 1
                    _fail(f"{label:28s}", e)
                if impl in ("core", "pallas", "pmerged"):
                    break  # margin is a no-op for exact impls
            if impl in ("core", "pallas"):
                break      # base_chunk too
    return failed


def cmd_lanegather(args) -> int:
    """Hierarchical gather probe: the lane-chain primitives, then the
    register-tile shuffle gather against the direct row-gather contraction;
    returns the number of parts that failed."""
    from snipper_tpu_torch.models.snipper import resolve_device
    from snipper_tpu_torch.scripts import lanegather_probe

    return lanegather_probe.run(K=args.K, device=resolve_device(args.device))


def _seeded_state(cfg, device):
    """A model of ``cfg`` seeded with 0 on ``device``, its sampling
    projections' weights drawn at random so that queries sample different
    places."""
    from snipper_tpu_torch.models.snipper import build_model

    model = build_model(cfg, device=device, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def _impl(device) -> str:
    """The MSDA the model runs on ``device``."""
    return "msda_forward" if device.type == "cuda" else "ms_deform_attn_torch"


def cmd_serve(args) -> int:
    """The exported artifact against the live forward, both on bf16
    weights and an f32 input: the artifact's size, then ms per snippet of
    each, timed in turns (live, artifact, artifact, live, twice; the
    median of each), and their ratio; returns 0."""
    import os
    import statistics
    import tempfile

    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.infer.export import (ServingForward,
                                                export_forward,
                                                load_exported, save_exported)
    from snipper_tpu_torch.models.snipper import resolve_device

    device = resolve_device(args.device)
    cfg = getattr(Config, args.preset)()
    dt = "bfloat16"
    print(f"serving artifact probe on {device}: {args.preset}, {dt} "
          f"weights, f32 input, batch 1", flush=True)
    model = _seeded_state(cfg, device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(
        0, 1, (1, cfg.num_frames, cfg.input_height, cfg.input_width, 3)
    ).astype(np.float32)).to(device)
    with tempfile.TemporaryDirectory() as d:
        exported = export_forward(cfg, model.state_dict(), device=device.type,
                                  param_dtype=dt)
        path = os.path.join(d, "model.pt2")
        size = save_exported(exported, path)
        ops = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
        print(f"artifact: {size / 1e6:.1f} MB ({dt} weights), {len(ops)} "
              f"ops, {sum('msda_forward' in t for t in ops)} msda_forward",
              flush=True)
        run = load_exported(path)
    # the artifact's forward, run live: the same weights cast to bf16 once
    serving = ServingForward(model, dt).eval()

    def live(xx):
        with torch.inference_mode():
            return serving(xx)["pred_logits"]

    times = {live: [], run: []}
    for _ in range(2):
        for fn in (live, run, run, live):
            times[fn].append(time_fn(lambda xx: fn(xx)["pred_logits"]
                                     if fn is run else fn(xx), x, K=args.K,
                                     repeats=1))
    ms_live, ms_art = (statistics.median(times[f]) for f in (live, run))
    print(f"live forward ({_impl(device)}, {dt}): {ms_live:7.2f} "
          f"ms/snippet", flush=True)
    print(f"artifact (load_exported, {dt}): {ms_art:7.2f} ms/snippet "
          f"({ms_art / ms_live:.3f}x live)", flush=True)
    return 0


def cmd_fast(args) -> int:
    """Serving-profile throughput: one seeded state dict cast to bf16
    (``bf16_params``), mapped to each profile of ``--specs`` and timed
    through the model on a bf16 input; returns the number of specs that
    failed."""
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.infer.fast import fast_profiles
    from snipper_tpu_torch.models.snipper import (bf16_model, bf16_params,
                                                  build_model,
                                                  resolve_device)

    device = resolve_device(args.device)
    base = getattr(Config, args.preset)()
    print(f"fast-profile probe on {device}: {args.preset}, bf16 weights "
          f"and input, batch {args.batch}", flush=True)
    full = bf16_params(_seeded_state(base, device).state_dict())
    rng = np.random.default_rng(0)
    base_sps, failed = None, 0
    for spec in args.specs.split("|"):
        spec = spec.strip()
        try:
            if spec in ("", "base"):
                cfg, state, label = base, full, "base"
            else:
                cfg, transform = fast_profiles(base, spec)
                state, label = transform(full), spec
            model = bf16_model(build_model(cfg, device=device, seed=0))
            model.load_state_dict(state)
            x = torch.from_numpy(rng.uniform(
                0, 1, (args.batch, cfg.num_frames, cfg.input_height,
                       cfg.input_width, 3)).astype(np.float32)).to(
                           device, torch.bfloat16)
            with torch.inference_mode():
                ms = time_fn(lambda xx: model(xx)["pred_logits"], x,
                             K=args.K)
            del model
            sps = 1e3 / (ms / args.batch)
            if label == "base":
                base_sps = sps
            rel = f"  {sps / base_sps:.2f}x base" if base_sps else ""
            print(f"{label:16s}: {sps:6.2f} snippets/s  [{_impl(device)} bf16 "
                  f"{cfg.input_height}x{cfg.input_width} enc{cfg.enc_layers} "
                  f"P={cfg.enc_n_points}/{cfg.dec_n_points}]{rel}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - reported, counted
            failed += 1
            _fail(spec, e)
    return failed


def _meshscale_rank(cfg, n: int, K: int, device_type: str):
    """One rank's part of ``meshscale`` at N = ``n``: its B/N rows of the
    seeded global batch through the seeded model, K forwards timed between
    two barriers. Returns ``(seconds per forward, row ids)`` of every rank
    (``n == 1``: this process alone, no process group)."""
    import os

    from snipper_tpu_torch.models.snipper import build_model
    from snipper_tpu_torch.parallel import multihost

    rank = multihost.process_index()
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max((os.cpu_count() or 1) // n, 1))
    model = build_model(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (n, cfg.num_frames, cfg.input_height,
                           cfg.input_width, 3)).astype(np.float32)
    per = x.shape[0] // n
    rows = np.arange(rank * per, (rank + 1) * per)
    local = torch.from_numpy(x[rows]).to(device)
    # the batch is really split: each rank holds exactly B/N rows
    if local.shape[0] != x.shape[0] // n:
        raise AssertionError(f"rank {rank} holds {local.shape[0]} rows of "
                             f"a global batch of {x.shape[0]} over {n}")
    with torch.inference_mode():
        model(local)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        multihost.barrier()
        t0 = time.perf_counter()
        for _ in range(K):
            model(local)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = (time.perf_counter() - t0) / K
        multihost.barrier()
    return multihost.all_gather_objects((dt, rows.tolist()))


def cmd_meshscale(args) -> int:
    """Data-parallel scaling: N ranks, each with B/N = 1 snippet of a
    global batch of N, N in {1, 4, 8}; returns 0 (a rank that breaks the
    B/N check raises)."""
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.models.snipper import resolve_device
    from snipper_tpu_torch.parallel import multihost

    device = resolve_device(args.device)
    cfg = getattr(Config, args.preset)()
    if args.size:
        h, w = (int(v) for v in args.size.split("x"))
        cfg = cfg.replace(input_height=h, input_width=w)
    visible = torch.cuda.device_count() if device.type == "cuda" else None
    n_dev = args.devices or visible or 1
    if visible is not None and n_dev > visible:
        raise ValueError(f"--devices {n_dev}: {visible} cards visible")
    print(f"meshscale probe on {device.type}: {args.preset} "
          f"{cfg.input_height}x{cfg.input_width}, f32 forward, {n_dev} "
          f"devices", flush=True)
    t1 = None
    for n in (1, 4, 8):
        if n > n_dev:
            print(f"n={n}: skipped ({n_dev} devices)", flush=True)
            continue
        work = (cfg, n, args.K, device.type)
        per_rank = (_meshscale_rank(*work) if n == 1 else multihost.spawn(
            _meshscale_rank, n, work,
            backend=multihost.default_backend(device))[0])
        dt = max(t for t, _ in per_rank)
        rows = sorted(r for _, rs in per_rank for r in rs)
        if rows != list(range(n)):
            raise AssertionError(f"n={n}: the ranks' rows {rows} do not "
                                 f"split the global batch")
        if n == 1:
            t1 = dt
        eff = t1 / (dt / n)
        print(f"n={n}: {dt * 1e3:8.1f} ms / global batch {n}  "
              f"({dt / n * 1e3:7.1f} ms/shard, overhead-eff {eff:.3f})",
              flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("forward")
    f.add_argument("--presets", default="canonical_t4,canonical_t4_f2,"
                   "light_t4_f2,light_t4,light_t1,canonical_t1,"
                   "jta_forecast,panoptic")
    f.add_argument("--impl", default="windowed")
    f.add_argument("--batch", default="1")
    f.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    f.add_argument("-K", type=int, default=8)
    f.add_argument("--device", default="cuda")
    f.set_defaults(fn=cmd_forward)

    t = sub.add_parser("train")
    t.add_argument("--preset", default="canonical_t4_f2")
    t.add_argument("--impls", default="xla")
    t.add_argument("--mp", default="on", choices=("on", "off", "both"))
    t.add_argument("--remat", default="save_sampling")
    t.add_argument("--batch_size", type=int, default=2)
    t.add_argument("-K", type=int, default=4)
    t.add_argument("--profile_dir", default=None,
                   help="trace the timed steps (torch.profiler) and print "
                        "the top-20 device ops")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train, inference=False)

    s = sub.add_parser("split")
    s.add_argument("--preset", default="canonical_t4")
    s.add_argument("-K", type=int, default=10)
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_split)

    o = sub.add_parser("op")
    o.add_argument("--impls", default="windowed,core")
    o.add_argument("--base_chunk", default="512")
    o.add_argument("--margin", default="5")
    o.add_argument("--max_off_px", type=float, default=4.0)
    o.add_argument("-K", type=int, default=8)
    o.add_argument("--device", default="cuda")
    o.set_defaults(fn=cmd_op)

    lg = sub.add_parser("lanegather")
    lg.add_argument("-K", type=int, default=8)
    lg.add_argument("--device", default="cuda")
    lg.set_defaults(fn=cmd_lanegather)

    sv = sub.add_parser("serve")
    sv.add_argument("--preset", default="canonical_t4")
    sv.add_argument("-K", type=int, default=10)
    sv.add_argument("--device", default="cuda")
    sv.set_defaults(fn=cmd_serve, inference=False)

    fa = sub.add_parser("fast")
    fa.add_argument("--preset", default="canonical_t4")
    fa.add_argument("--specs", default="base|m3|r480|enc4|p2|enc4,p2|"
                    "enc4,p2,r480")
    fa.add_argument("--batch", type=int, default=1)
    fa.add_argument("-K", type=int, default=12)
    fa.add_argument("--device", default="cuda")
    fa.set_defaults(fn=cmd_fast, inference=False)

    ms = sub.add_parser("meshscale")
    ms.add_argument("--preset", default="light_t4")
    ms.add_argument("--size", default=None,
                    help="HxW input override (e.g. 96x128)")
    ms.add_argument("--devices", type=int, default=None,
                    help="devices to spread over (default: the visible "
                         "cards; 1 on the CPU)")
    ms.add_argument("-K", type=int, default=4)
    ms.add_argument("--device", default="cuda")
    ms.set_defaults(fn=cmd_meshscale)

    args = p.parse_args(argv)
    # train, serve and fast run autograd or an export: no inference mode
    with torch.inference_mode(getattr(args, "inference", True)):
        failed = args.fn(args)
    print("DONE", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
