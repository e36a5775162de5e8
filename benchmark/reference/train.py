"""The plain reference of one training update (reference ``engine.py``
``train_one_epoch`` and ``main.py:201-222``): forward, the criterion,
backward, the gradients clipped to ``clip_max_norm`` by their global norm
(``g / norm * max_norm`` when the norm is at least ``max_norm``), then one
AdamW update (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay) with
the backbone at ``lr_backbone``, the reference-point and sampling-offset
projections at ``lr * lr_linear_proj_mult`` and the rest at ``lr``. The
frozen tensors (``model.frozen``) get no gradient and no update.

The forward, the criterion and the backward may run over blocks of rows of
the batch, so that a large batch fits the card: each block's loss takes the
whole batch's normalisers (``criterion.criterion``'s ``batch_valid``), and
the blocks' gradients are summed in f64 before the clip and the update,
which see the whole batch's gradient.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import criterion as crit
from benchmark.reference import model as ref_model
from benchmark.reference.precision import Precision


class AdamW:
    """AdamW over named tensors, written out."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict):
        self.lr = {"backbone": cfg["lr_backbone"],
                   "proj": cfg["lr"] * cfg["lr_linear_proj_mult"],
                   "main": cfg["lr"]}
        self.wd = cfg["weight_decay"]
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            lr = self.lr[ref_model.lr_group(k)]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def train_steps(P: Dict[str, torch.Tensor], batches: List[Dict], cfg: dict,
                prec: Precision = Precision(),
                rows: Optional[int] = None) -> Dict:
    """Run one update per batch from weights ``P`` (left as they are),
    the forward and backward over blocks of ``rows`` rows (the whole batch
    at once when None). Returns ``loss`` (per step, the sum of the blocks'
    totals), ``grad`` (the first step's clipped gradient, as the optimizer
    receives it, by name), ``start`` and ``params`` (the trained tensors
    before the first and after the last step)."""
    trained = {k: v.detach().clone() for k, v in P.items()
               if not ref_model.frozen(k)}
    fixed = {k: v.detach() for k, v in P.items() if ref_model.frozen(k)}
    start = {k: v.clone() for k, v in trained.items()}
    opt = AdamW(trained, cfg)
    losses, first = [], None
    for batch in batches:
        leaves = {k: v.requires_grad_(True) for k, v in trained.items()}
        names = list(leaves)
        n = batch["images"].shape[0]
        step = rows or n
        total, gs = 0.0, None
        for a in range(0, n, step):
            block = {"images": batch["images"][a:a + step],
                     "targets": {k: v[a:a + step]
                                 for k, v in batch["targets"].items()}}
            # the network and its backward in the step's precision, the
            # criterion in f32 (the bf16 recipe's criterion reads f32)
            with prec.everywhere():
                out = ref_model.forward({**fixed, **leaves}, block["images"],
                                        cfg, prec)
            loss, _, _ = crit.criterion(out, block["targets"], cfg,
                                        batch["targets"]["valid"])
            with prec.everywhere():
                g = torch.autograd.grad(loss, [leaves[k] for k in names])
            g = [x.double() for x in g]
            gs = g if gs is None else [x + y for x, y in zip(gs, g)]
            total += float(loss.detach())
            del out, loss, g
        norm = torch.sqrt(sum(torch.sum(g ** 2) for g in gs))
        scale = (cfg["clip_max_norm"] / norm if norm >= cfg["clip_max_norm"]
                 else torch.ones((), dtype=torch.float64))
        grads = {k: (g * scale).float() for k, g in zip(names, gs)}
        del gs
        for v in trained.values():
            v.requires_grad_(False)
        opt.step(trained, grads)
        losses.append(total)
        if first is None:
            first = grads
    return {"loss": losses, "grad": first, "start": start,
            "params": trained}
