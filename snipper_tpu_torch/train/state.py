"""Optimizer (three learning-rate groups), frozen set, StepLR and the
train state.

Counterpart of ``snipper_tpu/train/state.py:31-128`` (reference
``main.py:201-222``): AdamW (b1 0.9, b2 0.999, eps 1e-8, ``weight_decay``
on every trained parameter) with
- backbone parameters at ``lr_backbone``,
- the ``reference_points`` / ``sampling_offsets`` projections at
  ``lr * lr_linear_proj_mult``,
- everything else at ``lr``,
and a StepLR drop of 10x every ``lr_drop`` epochs, stepped per optimizer
update. The frozen set (the stem ``conv1``, ``layer1_*`` and the
FrozenBatchNorm statistics, reference ``models/backbone.py:71-73``) gets
``requires_grad=False``: it is in no optimizer group and outside the
clip's norm, as ``mask_frozen_grads`` (``:49-60``) keeps it there. The
FrozenBatchNorm tensors are buffers in the port, never parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from snipper_tpu_torch.config import Config


def param_label(name: str) -> str:
    """Label a parameter name: frozen | backbone | proj | main."""
    parts = name.split(".")
    if parts[0] == "backbone":
        if any(p.startswith("bn") or p == "downsample_bn" for p in parts):
            return "frozen"
        if len(parts) > 1 and (parts[1] in ("conv1", "bn1")
                               or parts[1].startswith("layer1_")):
            return "frozen"
        return "backbone"
    if any(p in ("sampling_offsets", "reference_points") for p in parts):
        return "proj"
    return "main"


def step_lr(base_lr: float, lr_drop_epochs: int, steps_per_epoch: int,
            gamma: float = 0.1) -> Callable[[int], float]:
    """StepLR as a per-update schedule."""

    def sched(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // lr_drop_epochs)

    return sched


@dataclasses.dataclass
class TrainState:
    """What a train step reads and updates.

    ``step`` counts train-step calls (microbatches), as the JAX state's
    ``step``; ``updates`` counts optimizer updates, which drive the
    StepLR schedules. ``accum`` holds the running mean of the current
    accumulation window's gradients (``grad_accum_steps > 1``)."""
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    params: List[torch.nn.Parameter]
    lr_fns: List[Callable[[int], float]]
    cfg: Config
    step: int = 0
    updates: int = 0
    accum: Optional[List[torch.Tensor]] = None

    def state_dict(self) -> Dict:
        """``opt_state`` of a checkpoint."""
        return {"adamw": self.optimizer.state_dict(),
                "updates": self.updates,
                "accum": (None if self.accum is None
                          else [a.cpu() for a in self.accum])}

    def load_state_dict(self, opt_state: Dict, step: int):
        self.optimizer.load_state_dict(opt_state["adamw"])
        self.updates = int(opt_state["updates"])
        dev = self.params[0].device
        self.accum = (None if opt_state["accum"] is None
                      else [a.to(dev) for a in opt_state["accum"]])
        self.step = int(step)


def create_train_state(cfg: Config, model: torch.nn.Module,
                       steps_per_epoch: int = 1000) -> TrainState:
    """Freeze the frozen set and build AdamW over the three trained
    groups. ``steps_per_epoch`` counts microbatches; the schedules step per
    optimizer update."""
    accum = max(cfg.grad_accum_steps, 1)
    sched_steps = max(-(-steps_per_epoch // accum), 1)
    base_lr = {"backbone": cfg.lr_backbone,
               "proj": cfg.lr * cfg.lr_linear_proj_mult, "main": cfg.lr}
    groups = {k: [] for k in base_lr}
    for name, p in model.named_parameters():
        label = param_label(name)
        p.requires_grad_(label != "frozen")
        if label != "frozen":
            groups[label].append(p)
    names = [k for k in base_lr if groups[k]]
    optimizer = torch.optim.AdamW(
        [{"params": groups[k], "lr": base_lr[k]} for k in names],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    lr_fns = [step_lr(base_lr[k], cfg.lr_drop, sched_steps) for k in names]
    params = [p for k in names for p in groups[k]]
    return TrainState(model=model, optimizer=optimizer, params=params,
                      lr_fns=lr_fns, cfg=cfg)
