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

Under tensor parallelism (``state.mesh``) the cut parameters' AdamW
moments and accumulated gradients are this rank's pieces as well:
``state_dict`` gathers them into the full tensors (a collective over the
model group) and ``load_state_dict`` cuts a full one, so that a checkpoint
is the same file at any ``tp_size``.

On one card, in one process and without accumulation the train step runs
as a CUDA graph (``train/step.py::StepGraph``), kept in ``state.graph``.
AdamW is then ``capturable``: its step counts live on the card and each
group's rate is a tensor on the card, written before each step. A
checkpoint of a capturable AdamW holds the host form all the same (rates
as floats, step counts on the host, ``capturable`` off), so that a file is
the same whatever wrote it and loads wherever it is read; a capturable
AdamW that loads one is made capturable again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.parallel.mesh import cut, gather


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
    accumulation window's gradients (``grad_accum_steps > 1``). ``mesh``
    is the ``parallel.mesh.Mesh`` the step runs on (None: one process).
    ``graphed``: the step runs as a CUDA graph where it can (set on one
    card, in one process and without accumulation; cleared, every step
    runs eagerly); ``graph`` is that graph (``train/step.py::StepGraph``),
    once the first graphable step has given it its batch signature."""
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    params: List[torch.nn.Parameter]
    lr_fns: List[Callable[[int], float]]
    cfg: Config
    step: int = 0
    updates: int = 0
    accum: Optional[List[torch.Tensor]] = None
    mesh: Optional[Any] = None
    graphed: bool = False
    graph: Optional[Any] = dataclasses.field(default=None, repr=False)

    def _per_param(self, fn, tensors):
        """``fn(tensor, tp_spec)`` on each parameter's tensor of a cut
        parameter; the others as they are."""
        return [t if getattr(p, "tp_spec", None) is None
                else fn(t, p.tp_spec) for p, t in zip(self.params, tensors)]

    def _moments(self, adamw: Dict, fn) -> Dict:
        state = {}
        for i, s in adamw["state"].items():
            spec = getattr(self.params[i], "tp_spec", None)
            state[i] = s if spec is None else {
                k: fn(v, spec) if k in ("exp_avg", "exp_avg_sq") else v
                for k, v in s.items()}
        return dict(adamw, state=state)

    def state_dict(self) -> Dict:
        """``opt_state`` of a checkpoint, with full tensors (under tensor
        parallelism every rank of the model group must call this)."""
        adamw, accum = self.optimizer.state_dict(), self.accum
        if self.mesh is not None and self.mesh.model_group is not None:
            def full(t, spec):
                return gather(t, spec, self.mesh)

            adamw = self._moments(adamw, full)
            accum = None if accum is None else self._per_param(full, accum)
        if _capturable(self.optimizer):
            adamw = _host_form(adamw)
        return {"adamw": adamw, "updates": self.updates,
                "accum": None if accum is None else [a.cpu() for a in accum]}

    def load_state_dict(self, opt_state: Dict, step: int):
        adamw, accum = opt_state["adamw"], opt_state["accum"]
        if self.mesh is not None and self.mesh.model_group is not None:
            def piece(t, spec):
                return cut(t, spec, self.mesh.tp, self.mesh.model_rank)

            adamw = self._moments(adamw, piece)
            accum = None if accum is None else self._per_param(piece, accum)
        capturable = _capturable(self.optimizer)
        self.optimizer.load_state_dict(adamw)
        if capturable:
            make_capturable(self.optimizer)
        # the graph captured the moments that were replaced
        self.graph = None
        self.updates = int(opt_state["updates"])
        dev = self.params[0].device
        self.accum = None if accum is None else [a.to(dev) for a in accum]
        self.step = int(step)


def _capturable(optimizer: torch.optim.AdamW) -> bool:
    return any(g.get("capturable") for g in optimizer.param_groups)


def _host_form(adamw: Dict) -> Dict:
    """A capturable AdamW's ``state_dict`` in the form a non-capturable
    one writes: rates as floats, step counts on the host, ``capturable``
    off."""
    groups = [dict(g, lr=float(g["lr"]), capturable=False)
              for g in adamw["param_groups"]]
    state = {i: dict(s, step=s["step"].cpu()) if "step" in s else s
             for i, s in adamw["state"].items()}
    return dict(adamw, param_groups=groups, state=state)


def make_capturable(optimizer: torch.optim.AdamW):
    """Make AdamW safe to capture in a CUDA graph on its parameters' card:
    each group ``capturable``, its rate a tensor there (written in place
    before each step, ``train/step.py::write_rates``), and the step counts
    of its state there in f32, where a capturable AdamW keeps them."""
    for group in optimizer.param_groups:
        dev = group["params"][0].device
        group["capturable"] = True
        group["lr"] = torch.tensor(float(group["lr"]), device=dev)
        for p in group["params"]:
            s = optimizer.state.get(p)
            if s and "step" in s:
                s["step"] = s["step"].to(dev, torch.float32)


def create_train_state(cfg: Config, model: torch.nn.Module,
                       steps_per_epoch: int = 1000,
                       mesh=None) -> TrainState:
    """Freeze the frozen set and build AdamW over the three trained
    groups. ``steps_per_epoch`` counts microbatches; the schedules step per
    optimizer update. ``mesh``: the mesh a sharded ``model`` was cut for
    (``parallel.mesh.shard_model``). On one card, without a mesh and
    without accumulation, AdamW is made capturable and ``graphed`` is set:
    the step runs as a CUDA graph. One card means one process: no mesh, or
    a mesh of one rank."""
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
    # a mesh of one rank (``cli.train`` in one process) issues no collective
    one_rank = mesh is None or mesh.dp * mesh.tp == 1
    graphed = one_rank and accum == 1 and params[0].is_cuda
    if graphed:
        make_capturable(optimizer)
    return TrainState(model=model, optimizer=optimizer, params=params,
                      lr_fns=lr_fns, cfg=cfg, mesh=mesh,
                      graphed=graphed)
