"""Train / eval epoch loops.

Counterpart of ``snipper_tpu/train/engine.py:28-176,205-304`` (reference
``engine.py``): ``train_one_epoch`` runs a step per batch, reads the
step's scalars with one host copy and aborts on a non-finite loss
(reference ``engine.py:68-71``); ``evaluate`` runs forward + criterion per
batch, the PostProcess and the 3D metrics over the current and the future
frames (reference ``engine.py:99-212``): MPJPE root/joint, pelvis-aligned
MPJPE and 3DPCK_rel @ 0.15 m, and PCKh on PoseTrack-style samples; on
request it collects the results and renders the first batches.

Over a mesh (``parallel/mesh.py``) every rank runs these loops on its own
batch shard; only rank 0 prints, the meters' averages are summed over the
data group at the end, and ``evaluate`` merges the ranks' results and
per-sample metric arrays with one gather each (JAX
``train/engine.py:262-277``), in data-rank order.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.data.loader import device_prefetch
from snipper_tpu_torch.eval.metrics import eval_kpts2d_pckh, eval_pose3d
from snipper_tpu_torch.infer.postprocess import postprocess
from snipper_tpu_torch.parallel.multihost import (all_gather_objects,
                                                  is_main_process,
                                                  merge_eval_results, print0)
from snipper_tpu_torch.train.step import batch_to_device, eval_step, \
    train_step
from snipper_tpu_torch.utils.logger import MetricLogger
from snipper_tpu_torch.utils.profiling import spanned

POSE3D_KEYS = ("mpjpe_root", "mpjpe_joint", "pel_mpjpe_joint", "3dpck")
PCKH_KEYS = ("pckh_root", "pckh_joint")


def inject_window_num_traj(batches, k: int):
    """Attach each accumulation window's loss normalizer.

    The reference normalizes every trajectory loss by ``num_traj``
    all-reduced across its k DDP ranks (``models/model.py:521-526``): each
    rank divides by ``max(N_global / k, 1)``. With gradient accumulation
    standing in for the k ranks, the normalizer spans the window's k
    microbatches; it is a function of the targets alone, so it is computed
    from a k-batch lookahead and attached as ``batch["num_traj"]``. A
    trailing partial window of j < k batches normalizes over its own j."""
    buf = []

    def flush():
        total = sum(float(np.sum(np.asarray(b["targets"]["valid"],
                                            dtype=np.float32)))
                    for b in buf)
        norm = np.float32(max(total / len(buf), 1.0))
        for b in buf:
            yield dict(b, num_traj=norm)
        buf.clear()

    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield from flush()
    if buf:
        yield from flush()


def _read_scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """All of a step's 0-d metrics in one device-to-host copy."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def train_one_epoch(state, criterion, loader, epoch: int,
                    generator: torch.Generator, device: torch.device,
                    mixed_precision: bool = True, print_freq: int = 10,
                    stop_flag: Optional[Callable[[], bool]] = None,
                    max_steps: Optional[int] = None,
                    grad_accum_steps: int = 1,
                    profile_dir: Optional[str] = None,
                    profile_steps: int = 3):
    """``max_steps``: stop the epoch after N steps. ``stop_flag`` is polled
    before each step; over several ranks it must return the same on all
    (``PreemptionGuard.poll``). Batches reach the card
    through ``device_prefetch`` (JAX ``train/engine.py:117-126``): the next
    batch's copy is issued, on a side stream on a card, before the current
    step runs. Returns ``(stats, history)``: the epoch's mean of each
    metric and, per step, its metrics, its host time in seconds (the step
    ends with the metrics read, so the card has finished it) and
    ``data_seconds``, the host time spent waiting for its batch (the
    loader, and issuing the next batch's copy).

    ``profile_dir``: trace ``profile_steps`` steps with ``torch.profiler``
    (from step 2, after the first step and one warm step; JAX
    ``train/engine.py:74-148``) into that directory and print the top
    device kernels by self time per step and the host spans: each step's
    wait for its batch (``train.wait``), ``train_step`` (``train.step``,
    with ``train.backward`` and ``train.update`` inside) and the read of
    its scalars (``train.readback``)."""
    logger = MetricLogger()
    history: List[Dict[str, float]] = []
    profiler = contextlib.ExitStack()
    profiling = False
    profiled = 0        # steps completed inside the trace window
    profile_start = 2   # skip the first step and one warm step
    if profile_dir is not None:
        n_total = max_steps
        if n_total is None:
            try:
                n_total = len(loader)
            except TypeError:
                n_total = None
        if n_total is not None and n_total < profile_start + profile_steps:
            # short epoch: still produce a trace rather than silently none
            profile_start = max(n_total - profile_steps, 0)
            print(f"profile window clamped to start at step {profile_start} "
                  "(short epoch — the trace may include compile/warm steps)",
                  flush=True)

    def finish_profile():
        nonlocal profiling
        if profiling:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.close()
            profiling = False
            _print_trace_summary(profile_dir, profiled)

    iterable = iter(loader)
    if grad_accum_steps > 1:
        iterable = inject_window_num_traj(iterable, grad_accum_steps)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    iterable = device_prefetch(
        iterable, lambda b: batch_to_device(b, device), stream=stream)
    t_data = time.perf_counter()
    for i, batch in enumerate(spanned(
            logger.log_every(iterable, print_freq, f"Epoch: [{epoch}]",
                             quiet=not is_main_process()), "train.wait")):
        if max_steps is not None and i >= max_steps:
            break
        if stop_flag is not None and stop_flag():
            print0("preemption signal received — stopping epoch early")
            break
        if profile_dir is not None and i == profile_start and not profiling:
            from snipper_tpu_torch.utils.profiling import trace

            profiler.enter_context(trace(profile_dir))
            profiling = True
        t0 = time.perf_counter()
        with record_function("train.step"):
            step_metrics = train_step(state, criterion, batch, generator,
                                      mixed_precision=mixed_precision)
        with record_function("train.readback"):
            metrics = _read_scalars(step_metrics)
        t_data, data_s = time.perf_counter(), t0 - t_data
        history.append(dict(metrics, seconds=t_data - t0,
                            data_seconds=data_s))
        if profiling:
            profiled += 1   # the read of the scalars ended this step
            if profiled >= profile_steps:
                finish_profile()
        # the step averages its metrics over the data group, and the ranks
        # of a model group compute the same loss: every rank stops here, or
        # none does
        loss = metrics["loss_total"]
        if not np.isfinite(loss):
            finish_profile()  # keep the trace of the steps that blew up
            print(f"Loss is {loss}, stopping training", flush=True)
            print(metrics, flush=True)
            sys.exit(1)
        logger.update(**metrics)
        logger.update(lr=state.lr_fns[-1](state.updates))
    finish_profile()  # the epoch ended before the window filled
    logger.synchronize_between_processes(
        None if state.mesh is None else state.mesh.data_group)
    print0("Averaged stats:", logger)
    return {k: m.global_avg for k, m in logger.meters.items()}, history


def _print_trace_summary(profile_dir: str, n_iters: int):
    from snipper_tpu_torch.utils.profiling import host_spans, summarize_trace

    top = summarize_trace(profile_dir, top_k=10, n_iters=max(n_iters, 1))
    print(f"profile trace written to {profile_dir}", flush=True)
    for name, ms in top.items():
        print(f"  {ms:8.2f} ms/step  {name}", flush=True)
    for name, ms in host_spans(profile_dir, max(n_iters, 1)).items():
        print(f"  {ms:8.2f} ms/step  host span {name}", flush=True)


def evaluate(model, criterion, loader, cfg: Config, device: torch.device,
             print_freq: int = 10, collect_results: bool = False,
             save_vis_dir: Optional[str] = None,
             save_vis_batches: int = 2, mesh=None) -> Dict:
    """Losses and 3D/2D pose metrics over ``loader``; ``_batches`` counts
    the batches and ``_batch_seconds`` holds each batch's host time (it
    ends with the outputs read to the host), both this rank's. ``mesh``:
    the stats and results are those of every data rank's shard.

    ``collect_results``: the PostProcess results of every sample are
    returned under ``_results``. ``save_vis_dir``: the first
    ``save_vis_batches`` batches get GT-vs-prediction keypoint renders
    written there (reference ``engine.py:132-135`` under ``save_vis``).

    Each batch's phases run in host spans: ``eval.upload``, ``eval.step``
    (the forward's ``model.*`` and the matching's ``match_layers``
    inside), ``eval.readback``, ``eval.postprocess``, then ``eval.metrics``
    (the renders when asked, PCKh and the 3D metrics)."""
    logger = MetricLogger()
    T, Tf = cfg.num_frames, cfg.num_future_frames
    pose3d = {k: [] for k in POSE3D_KEYS}
    pose3d_future = {k: [] for k in POSE3D_KEYS}
    pckh = {k: [] for k in PCKH_KEYS}
    all_results, batch_seconds = [], []
    quiet = not is_main_process()
    for batch_idx, batch in enumerate(logger.log_every(loader, print_freq,
                                                       "Eval:", quiet)):
        t0 = time.perf_counter()
        with record_function("eval.upload"):
            on_device = batch_to_device(batch, device)
        with record_function("eval.step"):
            outputs, losses, src_idx = eval_step(model, criterion, on_device)
        with record_function("eval.readback"):
            logger.update(**_read_scalars(losses))
            outputs_np = {k: outputs[k].float().cpu().numpy() for k in
                          ("pred_logits", "pred_kpts2d", "pred_depth")}
            src_np = src_idx.cpu().numpy()
        with record_function("eval.postprocess"):
            results = postprocess(outputs_np, batch["meta"], src_np)
        batch_seconds.append(time.perf_counter() - t0)
        if collect_results:
            all_results.extend(results)
        with record_function("eval.metrics"):
            if save_vis_dir is not None and batch_idx < save_vis_batches:
                from snipper_tpu_torch.infer.visualize import \
                    save_eval_keypoint_renders

                save_eval_keypoint_renders(
                    results, np.asarray(batch["images"]), save_vis_dir,
                    batch_idx=batch_idx)
            # 2D PCKh on posetrack-style samples (reference
            # eval_utils.py:96-175; observed frames only)
            for key in PCKH_KEYS:
                v = eval_kpts2d_pckh(key, results, 0, T)
                if v is not None and v.size:
                    pckh[key].append(v)
            for key in POSE3D_KEYS:
                mkey = "pel_mpjpe_joint" if key == "3dpck" else key
                cur = eval_pose3d(mkey, results, 0, T)
                pose3d[key].append((cur < 0.15).astype(np.float32)
                                   if key == "3dpck" else cur)
                if Tf > 0:
                    fut = eval_pose3d(mkey, results, T, T + Tf)
                    pose3d_future[key].append(
                        (fut < 0.15).astype(np.float32) if key == "3dpck"
                        else fut)

    group = None if mesh is None else mesh.data_group
    if group is not None:
        # each data rank held a disjoint shard: a true union (replaces
        # the reference's pickle-file rendezvous, main.py:291-322)
        if collect_results:
            all_results = merge_eval_results(all_results, group)
        for acc in (pose3d, pose3d_future, pckh):
            local = {k: (np.concatenate(v) if v else np.zeros((0,)))
                     for k, v in acc.items()}
            gathered = all_gather_objects(local, group)  # one per acc
            for k in acc:
                acc[k] = [chunk[k] for chunk in gathered]
        logger.synchronize_between_processes(group)

    stats = {k: m.global_avg for k, m in logger.meters.items()}
    for name, acc in (("", pose3d), ("future_", pose3d_future), ("", pckh)):
        for k, chunks in acc.items():
            if not chunks:
                continue
            v = np.concatenate(chunks)
            if v.size:
                stats[f"{name}{k}"] = float(v.mean())
    print0("Eval stats:", {k: round(v, 4) for k, v in stats.items()
                           if not k.startswith("loss")})
    stats["_batches"] = len(batch_seconds)
    stats["_batch_seconds"] = batch_seconds
    if collect_results:
        stats["_results"] = all_results
    return stats
