"""Train and eval steps.

Counterpart of ``snipper_tpu/train/step.py:28-152,184-221``. One train step
is: forward in ``module.train()`` (bf16 ``torch.autocast`` with mixed
precision, the JAX CLI's default; f32 master weights), the criterion
outside autocast in f32, backward, the global-norm clip written as optax
writes it (``g / norm * max_norm`` when ``norm >= max_norm``;
``clip_grad_norm_`` adds 1e-6 and would not match), then AdamW. With
``grad_accum_steps = k`` the k microbatch gradients are averaged (a
running mean, as ``optax.MultiSteps``) and one clip + update runs on the
k-th. No step needs the JAX package's exact-redo branch: the sampling
kernels are exact gathers and ``sampling_overflow`` is always 0.

Dropout draws from the global generators inside ``torch.random.fork_rng``,
seeded per step from the caller's ``torch.Generator`` (seeded from
``cfg.seed`` by the CLI), so a run is reproducible and leaves the global
generators as it found them. Its bits are not JAX's.
"""

from __future__ import annotations

from typing import Dict

import torch

from snipper_tpu_torch.data.device_preprocess import warp_train_batch_device
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.train.state import TrainState


# the step inputs of a host batch: finished images, or the raw uint8
# frames with their warp parameters (``device_preprocess``)
INPUT_KEYS = ("images", "raw_images", "warp_inv", "color_scale", "num_traj")


def batch_to_device(batch: Dict, device: torch.device) -> Dict:
    """The step inputs of a host batch (``images``, or ``raw_images``,
    ``warp_inv`` and ``color_scale``; ``targets``; ``num_traj``) as tensors
    on ``device``. Copies to a card go from pinned memory without blocking:
    the train loader pins its batches (``DataLoader(pin_memory=True)``),
    and an array of a loader that does not, as the eval's, is pinned here."""
    def put(x):
        t = torch.as_tensor(x)
        if device.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(device, non_blocking=True)
        return t.to(device)

    out = {k: put(batch[k]) for k in INPUT_KEYS if k in batch}
    out["targets"] = {k: put(v) for k, v in batch["targets"].items()}
    return out


def forward_loss(model, criterion: SetCriterion, batch: Dict,
                 mixed_precision: bool):
    """``(total, losses, outputs, src_idx)`` of one batch on the model's
    current mode; the network under bf16 autocast when
    ``mixed_precision``, the criterion in f32 outside it. A batch of raw
    frames is warped first, in f32 outside autocast, so only the model
    sees bf16."""
    if "raw_images" in batch:  # JAX train/step.py:77-89
        images = warp_train_batch_device(
            batch["raw_images"], batch["warp_inv"], batch["color_scale"],
            criterion.cfg.input_shape)
    else:
        images = batch["images"]
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=mixed_precision):
        out = model(images, batch.get("mask"))
    total, losses, src_idx = criterion(out, batch["targets"],
                                       num_traj=batch.get("num_traj"))
    return total, losses, out, src_idx


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of all
    elements."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def train_step(state: TrainState, criterion: SetCriterion, batch: Dict,
               generator: torch.Generator,
               mixed_precision: bool = True) -> Dict[str, torch.Tensor]:
    """One microbatch. Returns the step's metrics as 0-d tensors on the
    device (``loss_total``, ``grad_norm`` of this microbatch's own
    gradients, every loss term, ``sampling_overflow``); read them with one
    host copy."""
    model, cfg = state.model, state.cfg
    model.train()
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    dev = batch["targets"]["valid"].device
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        total, losses, out, _ = forward_loss(model, criterion, batch,
                                             mixed_precision)
    grads = torch.autograd.grad(total, state.params)
    norm = global_norm(grads)
    metrics = {"loss_total": total.detach(), "grad_norm": norm,
               **{k: v.detach() for k, v in losses.items()},
               "sampling_overflow": torch.zeros((), device=dev)}

    k = max(cfg.grad_accum_steps, 1)
    micro = state.step % k
    state.step += 1
    if k > 1:
        if micro == 0:
            state.accum = [g.clone() for g in grads]
        else:
            for a, g in zip(state.accum, grads):
                a.add_((g - a) / (micro + 1))
        if micro < k - 1:
            return metrics
        grads, state.accum = state.accum, None
        norm = global_norm(grads)
    apply_update(state, grads, norm)
    return metrics


def apply_update(state: TrainState, grads, norm: torch.Tensor):
    """Global-norm clip of ``grads`` (global norm ``norm``) at
    ``cfg.clip_max_norm`` by optax's formula, without a host read, then
    one AdamW update at the StepLR rates."""
    max_norm = state.cfg.clip_max_norm
    clipped = norm >= max_norm
    for p, g in zip(state.params, grads):
        p.grad = torch.where(clipped, g / norm * max_norm, g)
    for group, lr_fn in zip(state.optimizer.param_groups, state.lr_fns):
        group["lr"] = lr_fn(state.updates)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.updates += 1


@torch.no_grad()
def eval_step(model, criterion: SetCriterion, batch: Dict):
    """Forward in ``module.eval()`` in f32 + criterion (for the losses and
    match indices, reference ``engine.py:117-129``). Returns
    ``(outputs, metrics, src_idx)``."""
    model.eval()
    total, losses, out, src_idx = forward_loss(model, criterion, batch,
                                               mixed_precision=False)
    metrics = {"loss_total": total, **losses,
               "sampling_overflow": torch.zeros((), device=total.device)}
    return out, metrics, src_idx
