"""Operations of the model's forward (and backward) pass, counted from the
configuration's shapes: ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference (``reference/model.py``) run on the meta device (two
operations per multiply-add of every matrix product and convolution), plus
the deformable sampling by :func:`counts.msda.forward_ops`, which the
counter does not see. The count is of the work, so it reads the same
whatever implements it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import msda
from benchmark.reference import model as ref_model


class _Sampling(torch.autograd.Function):
    """Stands in for the sampling on the meta device: the output's shape,
    and gradients of the inputs' shapes."""

    @staticmethod
    def forward(ctx, value, loc, attn):
        N, _, H, D = value.shape
        return value.new_empty(N, loc.shape[1], H * D)

    @staticmethod
    def backward(ctx, grad):
        return None, None, None


def model_flops(cfg: dict, batch: int, backward: bool = False) -> float:
    """Operations of one pass over ``batch`` snippets; ``backward``: the
    training step's forward and backward (no gradient of the frozen tensors
    or of the images; the sampling's backward counted as twice its
    forward)."""
    return _model_flops(tuple(sorted(cfg.items())), batch, backward)


@functools.lru_cache(maxsize=None)
def _model_flops(items, batch, backward):
    cfg = dict(items)
    sampled = []

    def sampling(value, shapes, loc, attn):
        sampled.append(msda.forward_ops(value.shape, loc.shape))
        return _Sampling.apply(value, loc, attn)

    P = {name: torch.empty(shape, device="meta",
                           requires_grad=backward
                           and not ref_model.frozen(name))
         for name, shape, _ in ref_model.param_spec(cfg)}
    images = torch.empty(batch, cfg["num_frames"], cfg["input_height"],
                         cfg["input_width"], 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        out = ref_model.forward(P, images, cfg, msda=sampling)
        if backward:
            leaves = [out[k] for k in ("pred_logits", "pred_kpts2d",
                                       "pred_depth", "aux_logits",
                                       "aux_kpts2d", "aux_depth")
                      if k in out] + list(out["heatmaps"])
            sum(t.sum() for t in leaves).backward()
    return float(counter.get_total_flops()
                 + sum(sampled) * (3 if backward else 1))
