"""Training traffic: the program's training loop,
``train/engine.py::train_one_epoch``, over its ``DataLoader`` and
``device_prefetch``, each step ``train_step`` with JAX's bf16 recipe over
f32 master weights (``mixed_precision=True``), as ``cli.train`` runs it.

Set-up builds one training state (model, AdamW, criterion) from the seed's
weights and drives it through its first ``check_steps`` steps by the
window's own call and feed, on batches of distinct samples; the same state
then trains through the window, where the loader cycles over the mix's
distinct samples in a shuffled order. The loop's ``stop_flag``, polled
before each step, closes the window; a step counts when it ended before
the close.

``correct``: the plain reference (``reference/train.py``) follows the
first steps from the same weights and batches, over blocks of
``REFERENCE_ROWS`` rows of each batch so that it fits the card.
``loss_gap``: the widest gap of a step's loss, over the reference's.
``grad_gap``: the first
step's gradient as the optimizer received it (AdamW's first moment after
one step, over 1 - beta1), by the worst leaf: the gap of the leaf's norms
over the larger of the reference leaf's norm and the median leaf's.
``change_gap``: the same of each leaf's change over the steps, leaving
out the leaves whose reference gradient is under a thousandth of the
median leaf's (a bias under a softmax, which AdamW moves by round-off
alone).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generate, harness
from benchmark.counts import flops as flop_counts
from benchmark.drivers.serve import build_program
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Precision
from benchmark.weights import make_weights

# rows of a batch the plain f32 reference runs at once: at canonical_t4_f2
# its per-level grid_sample keeps every level's sampled values for the
# backward, and a batch of 8 does not fit an 80 GB card
REFERENCE_ROWS = 2


def run(ctx) -> dict:
    from snipper_tpu_torch.data.loader import DataLoader
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.train import engine
    from snipper_tpu_torch.train import step as step_mod
    from snipper_tpu_torch.train.state import create_train_state

    mix, c = ctx.mix, ctx.cfg
    B, K = mix["batch"], mix["check_steps"]
    weights = make_weights(c, ctx.seed, ctx.device,
                           ctx.cfg_doc["person_logit"])
    cfg, model = build_program(ctx, weights)
    ctx.mark("weights")
    samples = generate.samples(c, mix["distinct_samples"], ctx.seed,
                               ctx.device)
    ctx.mark("inputs")
    state = create_train_state(cfg, model)
    crit = SetCriterion(cfg)
    names = {id(p): n for n, p in model.named_parameters()}
    pin = ctx.device.type == "cuda"
    gen = torch.Generator().manual_seed(ctx.seed)

    # ---- set-up: the first steps, read for the check ------------------------
    first = generate.SampleSet(samples[:B * K], B * K)
    snap, polled = {}, []

    def first_flag():
        if len(polled) == 1:   # after the first update
            snap["grad"] = {names[id(p)]: _first_grad_norm(state, p)
                            for p in state.params}
        polled.append(True)
        return False

    _, hist0 = engine.train_one_epoch(
        state, crit, DataLoader(first, B, shuffle=True, seed=ctx.seed,
                                pin_memory=pin),
        0, gen, ctx.device, mixed_precision=mix["mixed_precision"],
        stop_flag=first_flag)
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(
            (p.detach() - weights[n]).double()))
            for n, p in model.named_parameters() if p.requires_grad}
    prog = {"loss": [h["loss_total"] for h in hist0], "grad": snap["grad"],
            "change": change}
    order = list(first.reads)
    del weights

    # ---- the window --------------------------------------------------------
    data = generate.SampleSet(samples, mix["epoch_samples"])
    loader = DataLoader(data, B, shuffle=True, seed=ctx.seed + 1,
                        pin_memory=pin)
    polls = []
    close = None

    def window_flag():
        now = time.perf_counter()
        polls.append(now)
        ctx.trace_tick(len(polls) - 1, 1, mix["trace_steps"])
        return now >= close

    with harness.spans_around(ctx, [
            (engine, "train_step", "step", False),
            (step_mod, "apply_update", "update", False),
            (engine, "_read_scalars", "read_scalars", False),
            (engine, "device_prefetch", "input_wait", True)]):
        ctx.setup_done()
        close = time.perf_counter() + ctx.seconds
        _, hist = engine.train_one_epoch(
            state, crit, loader, 1, gen, ctx.device,
            mixed_precision=mix["mixed_precision"], stop_flag=window_flag)
        ctx.trace_close(len(polls) - 1)
    ctx.window_closed()
    del state, model, crit, loader
    ctx.free()

    polls = np.asarray(polls)
    ends = polls[1:]                       # step i ended at poll i + 1
    inside = ends <= close
    steps_in = int(inside.sum())
    traced = ctx.traced_mask(len(ends))
    data_s = np.asarray([h["data_seconds"] for h in hist])
    step_s = np.asarray([h["seconds"] for h in hist])
    ctx.data.update(
        data_wait_ms=(data_s[:len(ends)][inside & ~traced] * 1e3).tolist(),
        rate_untraced=harness.untraced_rate(int((inside & ~traced).sum()),
                                            ctx.seconds, ctx),
        flops_per_unit=flop_counts.model_flops(c, B, backward=True),
        unit_batch=B, precision=ctx.cfg_doc["precision"]["train"])
    e2e = {"train_samples_per_s": steps_in * B / ctx.seconds}

    # ---- correct -----------------------------------------------------------
    # the program's peak is read: from here the peak is the reference's
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    t_ref = time.perf_counter()
    batches = [_device_batch(samples, order[i:i + B], ctx.device)
               for i in range(0, B * K, B)]
    P = make_weights(c, ctx.seed, ctx.device, ctx.cfg_doc["person_logit"])
    rows = REFERENCE_ROWS
    ref = ref_train.train_steps(P, batches, c, Precision("float32"), rows)
    if ctx.control:
        got = _summary(ref_train.train_steps(
            P, batches, c, Precision(ctx.control), rows))
    else:
        got = prog
    del P
    reference = {"rows": rows, "seconds": time.perf_counter() - t_ref}
    if ctx.device.type == "cuda":
        reference["peak_bytes"] = int(torch.cuda.max_memory_allocated(
            ctx.device))
    ctx.free()
    want = _summary(ref)
    checks = compare(got, want, ctx.limits)
    diag = {"step_ms": float(np.mean(step_s) * 1e3),
            "data_ms": float(np.mean(data_s) * 1e3), "reference": reference,
            **_detail(got, want)}
    return {"attempted": steps_in, "failed": 0, "e2e": e2e,
            "checks": checks, "diag": diag}


def _first_grad_norm(state, p) -> float:
    """The norm of the gradient AdamW received for ``p`` in its first
    update: its first moment over 1 - beta1 (0 if it never stepped)."""
    m = state.optimizer.state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(
        torch.linalg.vector_norm(m.double() / 0.1))


def _device_batch(samples, idx, device):
    imgs = np.stack([samples[i]["images"] for i in idx])
    tg = {k: torch.from_numpy(np.stack([samples[i]["targets"][k]
                                        for i in idx])).to(device)
          for k in ("kpts2d", "depth", "valid")}
    return {"images": torch.from_numpy(imgs).to(device), "targets": tg}


def _summary(r: dict) -> dict:
    return {"loss": r["loss"],
            "grad": {k: float(torch.linalg.vector_norm(g.double()))
                     for k, g in r["grad"].items()},
            "change": {k: float(torch.linalg.vector_norm(
                (r["params"][k] - r["start"][k]).double()))
                for k in r["params"]}}


def _detail(got: dict, want: dict) -> dict:
    """Readings beside the compared ones: each step's loss gap, and the
    median leaf's gradient and change gaps."""
    def med_gap(a, b):
        keys = sorted(b, key=lambda k: b[k])
        k = keys[len(keys) // 2]
        return abs(a.get(k, 0.0) - b[k]) / b[k]

    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                          zip(got["loss"], want["loss"])],
            "grad_gap_median_leaf": med_gap(got["grad"], want["grad"]),
            "change_gap_median_leaf": med_gap(got["change"],
                                              want["change"]),
            "worst_grad_leaf": max(want["grad"], key=lambda k: abs(
                got["grad"].get(k, 0.0) - want["grad"][k]) / max(
                want["grad"][k], float(np.median(list(
                    want["grad"].values())))))}


def compare(got: dict, want: dict, limits: dict) -> dict:
    """The three numbers, each beside its limit."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                    want["loss"]))
    if len(got["loss"]) != len(want["loss"]):
        loss = float("inf")
    g_ref = want["grad"]
    med = float(np.median(list(g_ref.values())))

    def worst(a, b, keys):
        if set(a) != set(b):
            return float("inf")
        return max(abs(a[k] - b[k]) / max(b[k], med_of(b))
                   for k in keys)

    def med_of(b):
        return float(np.median(list(b.values())))

    grad = worst(got["grad"], g_ref, g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    change = worst(got["change"], want["change"], moved)
    return {"loss_gap": {"value": loss, "limit": limits["loss_gap"]},
            "grad_gap": {"value": grad, "limit": limits["grad_gap"]},
            "change_gap": {"value": change, "limit": limits["change_gap"]}}
