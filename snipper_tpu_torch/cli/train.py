"""Training entry point (counterpart of ``snipper_tpu/cli/train.py``,
reference ``main.py``).

    python -m snipper_tpu_torch.cli.train --preset canonical_t4_f2 \\
        --posetrack_dir DIR [--coco_dir DIR --muco_dir DIR --jta_dir DIR \\
        --panoptic_dir DIR --panoptic_protocol 1|2] [--device_preprocess] \\
        --output_dir OUT [--epochs N --steps_per_epoch S]
    python -m snipper_tpu_torch.cli.train --preset tiny --synthetic ...

Runs on the GPU unless ``--device cpu`` is given, with bf16 mixed precision
(f32 master weights and losses) unless ``--no-mixed_precision``. Each
epoch ends with a checkpoint, ``{output_dir}/ckpts/checkpoint{epoch:04d}.pt``,
and every ``--eval_every`` epochs with an evaluation on the validation
set; both go into ``{output_dir}/log.txt`` as one JSON line per epoch.
Training data is read from the reference-format directories given (the
files ``snipper_tpu_torch.data.preprocess`` writes), or is the synthetic
set when none is. ``--device_preprocess`` has the loader emit the raw
uint8 frames with their warp parameters and warps them inside the train
step on the device; the validation set is always warped on the host.
``--profile_dir DIR`` traces ``--profile_steps`` steps of the first epoch
with ``torch.profiler`` into DIR (a Chrome trace) and prints the top
device kernels by self time per step (``utils/profiling.py``).

On several GPUs, one process per GPU:

    torchrun --nproc_per_node N -m snipper_tpu_torch.cli.train \
        --preset canonical_t4_f2 ... [--tp_size 2]

The ranks form a ``(N / tp_size) x tp_size`` mesh (``parallel/mesh.py``).
Each data rank loads ``--batch_size`` samples of its own shard, so the
global batch is ``batch_size x N / tp_size``, and the gradients are
averaged over the data ranks; ``--tp_size`` > 1 cuts the transformer's
heads and FFN over the ranks of each model group. Every rank builds the
model from the same seed and takes rank 0's weights (and resumed state);
rank 0 prints, writes ``log.txt`` and the checkpoints, which hold the
full state at any ``tp_size``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from snipper_tpu_torch.cli.common import (add_config_args, add_data_args,
                                          build_config, build_dataset)
from snipper_tpu_torch.data.loader import DataLoader
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.models.snipper import build_model, resolve_device
from snipper_tpu_torch.parallel.mesh import (batch_sharding,
                                             gather_state_dict, make_mesh,
                                             shard_model)
from snipper_tpu_torch.parallel.multihost import (broadcast_module,
                                                  broadcast_object,
                                                  distributed,
                                                  is_main_process, print0,
                                                  process_count)
from snipper_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                load_checkpoint,
                                                load_torchvision_backbone,
                                                save_checkpoint)
from snipper_tpu_torch.train.engine import evaluate, train_one_epoch
from snipper_tpu_torch.train.preemption import PreemptionGuard
from snipper_tpu_torch.train.state import create_train_state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("snipper_tpu_torch trainer")
    add_config_args(parser)
    add_data_args(parser)
    parser.add_argument("--eval_every", type=int, default=1)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a torch.profiler trace of a few "
                             "steady-state steps of the FIRST epoch into "
                             "this directory and print the top device "
                             "kernels")
    parser.add_argument("--profile_steps", type=int, default=3)
    parser.add_argument("--device_preprocess", action="store_true",
                        help="warp/flip/color the training frames on the "
                             "device inside the train step (the host only "
                             "decodes); the host path's results "
                             "(data/device_preprocess.py)")
    parser.add_argument("--mixed_precision",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="bf16 autocast with f32 master weights and "
                             "losses (default); --no-mixed_precision for "
                             "full f32")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    """Train; returns ``{"start_epoch", "history", "checkpoint", "eval",
    "seconds"}``: per train step its metrics and host seconds, the last
    checkpoint's path and the last evaluation's stats."""
    args = build_parser().parse_args(argv)
    with distributed(resolve_device(args.device)) as device:
        return train(args, device)


def train(args, device: torch.device) -> dict:
    """``main`` on this rank's ``device``, in the process group (if any)
    that ``main`` joined."""
    cfg = build_config(args)
    mesh = make_mesh(-1, cfg.tp_size)
    main_rank = is_main_process()
    os.makedirs(args.output_dir, exist_ok=True)
    print0(f"config: {cfg}")
    print0(f"mesh: data {mesh.dp} x model {mesh.tp}")

    train_ds = build_dataset(cfg, args, "train",
                             device_preprocess=args.device_preprocess)
    # the val loader always warps on the host (JAX cli/train.py:69-71)
    val_ds = build_dataset(cfg, args, "val")
    # the train batches are pinned in the loader's thread, so that
    # device_prefetch's copy does not block; the eval pins in batch_to_device
    train_loader = DataLoader(train_ds, cfg.batch_size, shuffle=True,
                              seed=cfg.seed, num_workers=args.num_workers,
                              pin_memory=device.type == "cuda",
                              **batch_sharding(mesh))
    val_loader = DataLoader(val_ds, cfg.batch_size, shuffle=False,
                            num_workers=args.num_workers,
                            **batch_sharding(mesh))
    steps_per_epoch = args.steps_per_epoch or max(len(train_loader), 1)
    if steps_per_epoch % cfg.grad_accum_steps:
        print0(f"WARNING: steps_per_epoch {steps_per_epoch} is not a "
               f"multiple of grad_accum_steps {cfg.grad_accum_steps}: "
               "accumulation windows span epoch boundaries and a trailing "
               "partial window's gradients are dropped at exit")

    model = build_model(cfg, device=device, seed=cfg.seed)
    if args.pretrained_torch:
        from snipper_tpu_torch.convert import load_reference_checkpoint

        model.load_state_dict(load_reference_checkpoint(
            args.pretrained_torch, cfg))
        print0(f"imported torch checkpoint {args.pretrained_torch}")
    elif args.pretrained_backbone:
        n = load_torchvision_backbone(model, args.pretrained_backbone, cfg)
        print0(f"imported {n} tensors of the torchvision backbone "
               f"{args.pretrained_backbone}")
    n_params = sum(p.numel() for p in model.parameters())
    print0(f"parameters: {n_params / 1e6:.1f}M on {device}")

    start_epoch = 0
    ckpt_dir = os.path.join(args.output_dir, "ckpts")
    resume = args.resume
    if resume in ("auto", "latest"):
        resume = broadcast_object(latest_checkpoint(ckpt_dir))
        if resume is None:
            print0("--resume auto: no checkpoint yet — starting fresh")
    # rank 0's weights and resumed state on every rank, then this rank's
    # tensor-parallel shard
    ckpt = (broadcast_object(load_checkpoint(resume) if main_rank else None)
            if resume else None)
    if ckpt is not None:
        model.load_state_dict(ckpt["params"])
    broadcast_module(model)
    shard_model(model, mesh)
    crit = SetCriterion(cfg, mesh=mesh)
    state = create_train_state(cfg, model, steps_per_epoch, mesh=mesh)
    if ckpt is not None:
        state.load_state_dict(ckpt["opt_state"], ckpt["step"])
        start_epoch = state.step // steps_per_epoch
        print0(f"resumed from {resume} at epoch {start_epoch}")
    del ckpt
    # the window's num_traj needs every microbatch's targets of the
    # window; each rank sees only its shard, so over several ranks it
    # stays microbatch-local (JAX cli/train.py:144-151)
    accum = cfg.grad_accum_steps if process_count() == 1 else 1
    if accum != cfg.grad_accum_steps:
        print0("WARNING: multi-process run — the grad-accumulation "
               "num_traj normalizer is microbatch-local (exact window "
               "num_traj needs single-process target visibility)")

    guard = PreemptionGuard()
    history, ckpt_path, eval_stats = [], None, None
    t0 = time.time()
    try:
        for epoch in range(start_epoch, cfg.epochs):
            train_loader.set_epoch(epoch)
            # dropout stream per epoch, so a resumed run draws as an
            # uninterrupted one
            generator = torch.Generator().manual_seed(
                (cfg.seed + 1) * 1_000_003 + epoch)
            train_stats, hist = train_one_epoch(
                state, crit, train_loader, epoch, generator, device,
                mixed_precision=args.mixed_precision,
                stop_flag=guard.poll,
                max_steps=args.steps_per_epoch,
                grad_accum_steps=accum,
                profile_dir=(args.profile_dir
                             if epoch == start_epoch and main_rank
                             else None),
                profile_steps=args.profile_steps)
            history += hist
            ckpt_path = save_checkpoint(
                ckpt_dir, {"params": gather_state_dict(model.state_dict(),
                                                       mesh),
                           "opt_state": state.state_dict(),
                           "step": state.step}, epoch)
            stop = guard.poll()  # a signal during the epoch's last step
            print0(f"saved {ckpt_path}")

            log = {"epoch": epoch,
                   **{f"train_{k}": v for k, v in train_stats.items()}}
            if not stop and (epoch + 1) % args.eval_every == 0:
                eval_stats = evaluate(model, crit, val_loader, cfg, device,
                                      mesh=mesh)
                log.update({f"test_{k}": v for k, v in eval_stats.items()
                            if not k.startswith("_")})
            if main_rank:
                with open(os.path.join(args.output_dir, "log.txt"),
                          "a") as f:
                    f.write(json.dumps(log) + "\n")
            if stop:
                print0("checkpoint saved on preemption — exiting")
                break
    finally:
        guard.restore()
    seconds = time.time() - t0
    print0(f"done in {seconds:.0f}s")
    return {"start_epoch": start_epoch, "history": history,
            "checkpoint": ckpt_path, "eval": eval_stats, "seconds": seconds}


if __name__ == "__main__":
    main()
