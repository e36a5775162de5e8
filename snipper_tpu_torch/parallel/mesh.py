"""Rank mesh, batch and parameter shardings, and the tensor-parallel cuts.

Counterpart of ``snipper_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a ``Mesh`` with a ``data`` and a ``model`` axis inside one
process and lets XLA insert the collectives. The port runs one process
per GPU and issues them itself:

- rank ``r`` of a ``dp x tp`` world sits at ``(data = r // tp,
  model = r % tp)``; the ranks of one ``model`` group share a batch shard
  and split the transformer's heads and FFN, the ranks of one ``data``
  group see different shards and average their gradients;
- the transformer's weights are cut by ``_tp_spec``'s rules (column-
  parallel projections by output features, whole heads at a time; row-
  parallel ones by input features), and two conjugate autograd functions
  join the pieces: :func:`copy_to_model` (identity forward, all-reduce
  backward) at each column-parallel input and :func:`reduce_from_model`
  (all-reduce forward, identity backward) at each row-parallel output.

Everything else is replicated, so its gradients are equal on every rank of
a model group and only the data group averages them. The reference
parallelizes with NCCL DDP only (reference ``main.py:184``,
``util/misc.py:400-439``); DDP's reducer is not used because the train
step takes its gradients from ``torch.autograd.grad``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from snipper_tpu_torch.parallel.multihost import process_count, \
    process_index

# column-parallel projections (output features cut; their biases go with
# their rows) and row-parallel ones (input features cut; the bias is added
# once, after the reduction)
COLUMN = ("value_proj", "sampling_offsets", "attention_weights", "linear1")
ROW = ("output_proj", "out_proj", "linear2")


class Mesh:
    """A ``dp x tp`` layout of the first ``dp * tp`` ranks. ``data_group``
    (the ranks of this rank's model index) and ``model_group`` (those of its
    data index) are None where the axis has size 1 or this rank lies outside
    the mesh; a collective over a None group is never issued."""

    def __init__(self, dp: int, tp: int, rank: int, data_group=None,
                 model_group=None):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.data_group, self.model_group = data_group, model_group

    @property
    def contains(self) -> bool:
        return self.rank < self.dp * self.tp

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    def __repr__(self):
        return (f"Mesh(data={self.dp}, model={self.tp}, rank={self.rank} at "
                f"({self.data_rank}, {self.model_rank}))")


def make_mesh(dp_size: int = -1, tp_size: int = 1) -> Mesh:
    """The mesh over the default process group (a world of 1 without one):
    ``dp_size = -1`` takes all ranks left after ``tp_size``. Every rank
    must call it, in the same order as any other group creation."""
    n = process_count()
    if dp_size == -1:
        if n % tp_size:
            raise ValueError(f"world size {n} is not a multiple of tp_size "
                             f"{tp_size}")
        dp_size = n // tp_size
    if dp_size < 1 or tp_size < 1 or dp_size * tp_size > n:
        raise ValueError(f"mesh {dp_size} x {tp_size} does not fit a world "
                         f"of {n} ranks")
    rank = process_index()
    mesh = Mesh(dp_size, tp_size, rank)
    world = dp_size * tp_size == n
    if dp_size > 1:
        for m in range(tp_size):
            ranks = list(range(m, dp_size * tp_size, tp_size))
            g = (dist.group.WORLD if world and tp_size == 1
                 else dist.new_group(ranks))
            if mesh.contains and mesh.model_rank == m:
                mesh.data_group = g
    if tp_size > 1:
        for d in range(dp_size):
            ranks = list(range(d * tp_size, (d + 1) * tp_size))
            g = (dist.group.WORLD if world and dp_size == 1
                 else dist.new_group(ranks))
            if mesh.contains and mesh.data_rank == d:
                mesh.model_group = g
    return mesh


def batch_sharding(mesh: Mesh) -> Dict[str, int]:
    """The leading (batch) axis sharded over ``data``: the loader's
    ``process_index`` and ``process_count`` (the data rank, never the
    global rank, so that the ranks of a model group read the same shard)."""
    return {"process_index": mesh.data_rank, "process_count": mesh.dp}


# ----------------------------------------------------- parameter shardings
def _tp_spec(name: str) -> Optional[Tuple[int, int]]:
    """Tensor-parallel cut of the port's parameter ``name``: ``(dim,
    blocks)``, the tensor being ``blocks`` equal blocks along ``dim``, each
    cut into ``tp`` pieces; None where it is replicated. Torch keeps a
    linear weight as ``[out, in]``, so JAX's ``P(None, "model")`` kernel
    cut is dim 0 here and ``P("model", None)`` dim 1. The packed
    ``in_proj`` holds q, k and v as three row blocks, each cut by heads."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    parent, leaf = parts[-2], parts[-1]
    if leaf in ("in_proj_weight", "in_proj_bias"):
        return 0, 3
    if parent in COLUMN:
        return 0, 1
    if parent in ROW and leaf == "weight":
        return 1, 1
    return None


def param_shardings(mesh: Mesh, state_dict: Dict[str, torch.Tensor],
                    tensor_parallel: bool = False
                    ) -> Dict[str, Optional[Tuple[int, int]]]:
    """Each entry's cut over ``model`` (``_tp_spec``), or None where it is
    replicated; all None unless ``tensor_parallel`` on a model axis > 1."""
    on = tensor_parallel and mesh.tp > 1
    return {k: _tp_spec(k) if on else None for k in state_dict}


def cut(t: torch.Tensor, spec: Tuple[int, int], tp: int,
        index: int) -> torch.Tensor:
    """Model rank ``index``'s piece of the full tensor ``t``."""
    dim, blocks = spec
    return torch.cat([b.chunk(tp, dim)[index] for b in t.chunk(blocks, dim)],
                     dim).contiguous()


def gather(piece: torch.Tensor, spec: Tuple[int, int], mesh: Mesh
           ) -> torch.Tensor:
    """The full tensor from each model rank's ``piece``, on every rank of
    the model group (an all-reduce of zero-padded pieces, which NCCL and
    gloo both take on a card)."""
    dim, blocks = spec
    shape = list(piece.shape)
    shape[dim] *= mesh.tp
    full = piece.new_zeros(shape)
    for fb, pb in zip(full.chunk(blocks, dim), piece.chunk(blocks, dim)):
        fb.chunk(mesh.tp, dim)[mesh.model_rank].copy_(pb)
    dist.all_reduce(full, group=mesh.model_group)
    return full


def shard_state_dict(state_dict: Dict[str, torch.Tensor], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a full state dict."""
    specs = param_shardings(mesh, state_dict, tensor_parallel=True)
    return {k: v if specs[k] is None else cut(v, specs[k], mesh.tp,
                                               mesh.model_rank)
            for k, v in state_dict.items()}


def gather_state_dict(state_dict: Dict[str, torch.Tensor], mesh: Mesh
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict from every model rank's shard (a collective
    over the model group: every rank of it calls this)."""
    specs = param_shardings(mesh, state_dict, tensor_parallel=True)
    return {k: v if specs[k] is None else gather(v, specs[k], mesh)
            for k, v in state_dict.items()}


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Cut ``model``'s transformer weights in place to this rank's shard
    (each cut parameter gets its spec as ``tp_spec``) and hand the mesh to
    the modules that run the cut (their ``set_mesh``). A no-op on a model
    axis of 1."""
    if mesh.tp == 1:
        return model
    params = dict(model.named_parameters())
    specs = param_shardings(mesh, params, tensor_parallel=True)
    with torch.no_grad():
        for name, piece in shard_state_dict(params, mesh).items():
            if specs[name] is not None:
                params[name].data = piece
                params[name].tp_spec = specs[name]
    for module in model.modules():
        if hasattr(module, "set_mesh"):
            module.set_mesh(mesh)
    return model


# ------------------------------------------------- the conjugate functions
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A column-parallel input: itself forward, its gradient summed over
    the model group backward (each rank's projection sees part of it)."""
    if mesh is None or mesh.model_group is None:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A row-parallel output: summed over the model group forward, its
    gradient passed through backward. (``torch.distributed.nn``'s
    all-reduce sums again backward, which would scale every gradient
    upstream of the cut by ``tp``.)"""
    if mesh is None or mesh.model_group is None:
        return x
    return _ReduceFromModel.apply(x, mesh.model_group)


def row_parallel(linear: torch.nn.Linear, x: torch.Tensor,
                 mesh: Optional[Mesh]) -> torch.Tensor:
    """``linear(x)`` with ``linear``'s input features cut over the model
    group: the partial products summed, then the bias added once."""
    if mesh is None or mesh.model_group is None:
        return linear(x)
    return reduce_from_model(torch.nn.functional.linear(x, linear.weight),
                             mesh) + linear.bias


def dropout_shard(x: torch.Tensor, p: float, training: bool, dim: int,
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """Dropout of this rank's piece (cut along ``dim``) of a tensor that is
    cut over the model group: the mask is drawn for the whole tensor,
    which every rank of the group draws alike from the same seed, and
    sliced, so that the pieces' masks are not copies of each other."""
    if mesh is None or mesh.model_group is None or not training or p == 0:
        return torch.nn.functional.dropout(x, p, training)
    shape = list(x.shape)
    shape[dim] *= mesh.tp
    keep = torch.empty(shape, device=x.device, dtype=x.dtype).bernoulli_(
        1.0 - p).chunk(mesh.tp, dim)[mesh.model_rank]
    return x * keep / (1.0 - p)
