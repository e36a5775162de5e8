"""Train and eval steps.

Counterpart of ``snipper_tpu/train/step.py:28-152,184-221``. One train step
is: forward in ``module.train()`` (with mixed precision, the JAX CLI's
default, JAX's bf16 recipe: the network runs on bf16 copies of the f32
master weights and on bf16 images, and the gradients reach the masters
through the casts), the criterion in f32, backward, the global-norm clip
written as optax
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

Over a mesh (``state.mesh``, ``parallel/mesh.py``) each rank runs its own
batch shard. The gradients are averaged over the data group by one
all-reduce of their flattened concatenation, once per optimizer update
(after the accumulation window, before the clip, so that the clip sees
the global norm as JAX's does); under tensor parallelism the norm sums
the cut parameters' squares over the model group. The dropout seed folds
in the data rank (equal on the ranks of a model group, which must draw
alike), and the step's metrics are averaged over the data group, so that
``loss_total`` is the global batch's loss on every rank.

On one card, in one process (no mesh, or a mesh of one rank) and without
accumulation (``state.graphed``, ``train/state.py``) the step runs as a
CUDA graph, which takes the host's launches off the step's path. The
state's first step runs eagerly (AdamW's moments made, cuBLAS and cuDNN
warm); the next of the same batch signature captures the step
(:class:`StepGraph`) and replays it; every later one of that signature
copies its batch into the graph's inputs and replays, and a batch of
another signature runs eagerly. The eager and the captured step
run one body, :func:`_step`, with the same dropout bits (the seed is set
on the generators before the replay, which reads it there) and the same
StepLR rates (written into AdamW's rate tensors before the step).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch.profiler import record_function

from snipper_tpu_torch.data.device_preprocess import warp_train_batch_device
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.models.snipper import bf16_params
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
    current mode. With ``mixed_precision`` the network runs through
    ``torch.func.functional_call`` on ``bf16_params`` copies of its
    parameters and buffers and on the images cast to bf16, as JAX's loss
    casts ``params`` and the images inside the step (``snipper_tpu/train/
    step.py:91-95``); the casts are in the autograd graph, so the f32
    masters receive f32 gradients. A batch of raw frames is warped first,
    in f32, so only the model sees bf16. The criterion casts what it reads
    to f32 (``losses/criterion.py``), as JAX's does; it runs in the host
    span ``criterion`` (the matching's ``match_layers`` inside)."""
    if "raw_images" in batch:  # JAX train/step.py:77-89
        images = warp_train_batch_device(
            batch["raw_images"], batch["warp_inv"], batch["color_scale"],
            criterion.cfg.input_shape)
    else:
        images = batch["images"]
    if mixed_precision:
        weights = bf16_params({**dict(model.named_parameters()),
                               **dict(model.named_buffers())})
        out = torch.func.functional_call(
            model, weights, (images.to(torch.bfloat16), batch.get("mask")))
    else:
        out = model(images, batch.get("mask"))
    with record_function("criterion"):
        total, losses, src_idx = criterion(out, batch["targets"],
                                           num_traj=batch.get("num_traj"))
    return total, losses, out, src_idx


def global_norm(tensors, params=None, mesh=None) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of all elements.
    With a model group, ``tensors`` are the gradients of ``params``, and
    those of the cut parameters (``tp_spec``) are this rank's pieces: their
    squares are summed over the group."""
    if mesh is None or mesh.model_group is None:
        return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))
    sq = [torch.sum(t.float() ** 2) for t in tensors]
    cut = [getattr(p, "tp_spec", None) is not None for p in params]
    pieces = sum(s for s, c in zip(sq, cut) if c)
    dist.all_reduce(pieces, group=mesh.model_group)
    return torch.sqrt(sum(s for s, c in zip(sq, cut) if not c) + pieces)


def average_gradients(grads, mesh=None):
    """``grads`` averaged over the data group: one all-reduce of their
    flattened concatenation, divided by the group's size."""
    if mesh is None or mesh.data_group is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.dp
    return [f.view_as(g) for f, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def average_metrics(metrics: Dict[str, torch.Tensor], mesh=None
                    ) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over the data group (one all-reduce)."""
    if mesh is None or mesh.data_group is None:
        return metrics
    keys = list(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(vals, group=mesh.data_group)
    return dict(zip(keys, (vals / mesh.dp).unbind()))


def dropout_seed(generator: torch.Generator, mesh=None) -> int:
    """This step's dropout seed: drawn from ``generator`` (the same on
    every rank) and, on a data rank > 0, folded with that rank."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    if mesh is not None and mesh.data_rank:
        seed = (seed + mesh.data_rank * 0x9E3779B97F4A7C15) % 2 ** 62
    return seed


def train_step(state: TrainState, criterion: SetCriterion, batch: Dict,
               generator: torch.Generator,
               mixed_precision: bool = True) -> Dict[str, torch.Tensor]:
    """One microbatch. Returns the step's metrics as 0-d tensors on the
    device (``loss_total``, ``grad_norm`` of this microbatch's own
    gradients, every loss term, ``sampling_overflow``), averaged over the
    data group; read them with one host copy. With accumulation over a
    data group, a microbatch's ``grad_norm`` is the mean of the ranks'
    own norms (the average is taken at the window's end). Eagerly, the
    backward and the update run in the host spans ``train.backward`` and
    ``train.update``; as a graph, the capture runs in ``train.capture``,
    the copy of the batch into the graph's inputs in ``train.stage`` and
    the replay in ``train.replay``."""
    state.model.train()
    seed = dropout_seed(generator, state.mesh)
    write_rates(state)
    dev = batch["targets"]["valid"].device
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        graph = _graph_for(state, criterion, batch, mixed_precision)
        if graph is None:
            return _step(state, criterion, batch, mixed_precision)
        return graph.replay(state, batch)


def _step(state: TrainState, criterion: SetCriterion, batch: Dict,
          mixed_precision: bool) -> Dict[str, torch.Tensor]:
    """The step's work, eager or captured: forward and criterion, the
    backward, and at the end of an accumulation window the clip and the
    update."""
    cfg, mesh = state.cfg, state.mesh
    total, losses, out, _ = forward_loss(state.model, criterion, batch,
                                         mixed_precision)
    with record_function("train.backward"):
        grads = torch.autograd.grad(total, state.params)
    k = max(cfg.grad_accum_steps, 1)
    if k == 1:
        grads = average_gradients(grads, mesh)
    norm = global_norm(grads, state.params, mesh)
    dev = batch["targets"]["valid"].device
    metrics = average_metrics(
        {"loss_total": total.detach(), "grad_norm": norm,
         **{name: v.detach() for name, v in losses.items()},
         "sampling_overflow": torch.zeros((), device=dev)}, mesh)

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
        grads = average_gradients(state.accum, mesh)
        state.accum = None
        norm = global_norm(grads, state.params, mesh)
    with record_function("train.update"):
        apply_update(state, grads, norm)
    return metrics


def write_rates(state: TrainState):
    """Each AdamW group's StepLR rate for the next update, ``state.lr_fns``
    at ``state.updates``: written into the group's rate tensor where AdamW
    is capturable (a replay reads it there), else set as a float."""
    for group, lr_fn in zip(state.optimizer.param_groups, state.lr_fns):
        rate = lr_fn(state.updates)
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(rate)
        else:
            group["lr"] = rate


def apply_update(state: TrainState, grads, norm: torch.Tensor):
    """Global-norm clip of ``grads`` (global norm ``norm``) at
    ``cfg.clip_max_norm`` by optax's formula, without a host read, then
    one AdamW update at the rates :func:`write_rates` set."""
    max_norm = state.cfg.clip_max_norm
    clipped = norm >= max_norm
    for p, g in zip(state.params, grads):
        p.grad = torch.where(clipped, g / norm * max_norm, g)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.updates += 1


def _graph_for(state: TrainState, criterion: SetCriterion, batch: Dict,
               mixed_precision: bool):
    """The graph that runs this step, captured here at its signature's
    second step; None where the step runs eagerly: ``state.graphed``
    unset, a batch leaf not a card's tensor, the state's first graphable
    step (whose signature the graph takes), or a batch of another
    signature than the graph's. A state keeps one graph."""
    if not state.graphed:
        return None
    leaves = _leaves(batch)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for _, t in leaves):
        return None
    key = (id(criterion), mixed_precision,
           tuple((k, t.shape, t.dtype, t.device) for k, t in leaves))
    if state.graph is None:
        state.graph = StepGraph(key, criterion)
        return None
    if state.graph.key != key:
        return None
    if state.graph.graph is None:
        state.graph.capture(state, batch, mixed_precision)
    return state.graph


def _leaves(batch: Dict):
    """``(name, value)`` of each step input and each target."""
    return ([(k, v) for k, v in batch.items() if k != "targets"]
            + [(("targets", k), v) for k, v in batch["targets"].items()])


class StepGraph:
    """One train step, :func:`_step`, captured as a CUDA graph for one
    batch signature (``key``), on static inputs of that signature: the
    weight casts, the forward, the criterion with the matching, the
    backward, the clip and AdamW. The capture runs nothing: it leaves the
    state's step and update counts as it found them, and each replay adds
    one step and one update. A replay calls no kernel's wrapper, so the
    kernels' launch counters count the capture's launches once and no
    replay's; ``captures`` and ``replays`` count them in the process, as
    those counters do launches. A replay's metrics are fresh tensors, one
    copy of the graph's outputs."""

    captures = 0
    replays = 0

    def __init__(self, key, criterion: SetCriterion):
        self.key = key
        self.criterion = criterion   # held, so that its id stays its own
        self.graph = None

    def capture(self, state: TrainState, batch: Dict,
                mixed_precision: bool):
        """Capture the step on static inputs shaped as ``batch``."""
        self.inputs = {k: (torch.empty_like(v) if k != "targets" else
                           {n: torch.empty_like(t) for n, t in v.items()})
                       for k, v in batch.items()}
        counts = (state.step, state.updates)
        graph = torch.cuda.CUDAGraph()
        # thread-local: the loader's thread pins memory meanwhile
        with record_function("train.capture"), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            metrics = _step(state, self.criterion, self.inputs,
                            mixed_precision)
            self.keys = list(metrics)
            self.outputs = torch.stack([metrics[k].float()
                                        for k in self.keys])
        state.step, state.updates = counts
        self.graph = graph
        StepGraph.captures += 1

    def replay(self, state: TrainState, batch: Dict
               ) -> Dict[str, torch.Tensor]:
        """Copy ``batch`` into the inputs and run the step once."""
        with record_function("train.stage"):
            for (_, dst), (_, src) in zip(_leaves(self.inputs),
                                          _leaves(batch)):
                dst.copy_(src)
        with record_function("train.replay"):
            self.graph.replay()
        StepGraph.replays += 1
        state.step += 1
        state.updates += 1
        return dict(zip(self.keys, self.outputs.clone().unbind()))


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
