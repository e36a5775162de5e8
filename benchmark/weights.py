"""Seeded weights made on the device, in one draw.

Every random tensor of ``reference.model.param_spec`` is a slice of one
``torch.randn`` from a ``torch.Generator`` on the run's device, scaled by
its initialiser: ``lecun`` 1/sqrt(fan_in), ``xavier``
sqrt(2/(fan_in + fan_out)), ``normal`` 1, ``perturb`` 0.05 (the sampling
offset and attention weight projections, which are zero at the published
initialisation: perturbed, queries sample different places with different
weights, as trained weights make them). ``offsets`` is the published
initial offset grid; ``person`` is the class head's bias ``[0,
person_logit]``, which sets how many queries score a person. The same seed
on the same device gives the same weights, bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference.model import offset_bias, param_spec

RANDOM = ("lecun", "xavier", "normal", "perturb")


def _fans(shape):
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def make_weights(cfg: dict, seed: int, device, person_logit: float
                 ) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor on device}`` for ``cfg``'s model."""
    spec = param_spec(cfg)
    n = sum(math.prod(s) for _, s, kind in spec if kind in RANDOM)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(n, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        size = math.prod(shape)
        if kind in RANDOM:
            t = draw[at:at + size].view(shape)
            at += size
            if kind == "lecun":
                t = t * (1.0 / math.sqrt(_fans(shape)[0]))
            elif kind == "xavier":
                t = t * math.sqrt(2.0 / sum(_fans(shape)))
            elif kind == "perturb":
                t = t * 0.05
            out[name] = t
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "offsets":
            H, L = cfg["nheads"], cfg["num_feature_levels"]
            grid = offset_bias(H, L, size // (2 * H * L))
            out[name] = torch.from_numpy(grid).to(device)
        elif kind == "person":
            out[name] = torch.tensor([0.0, person_logit], device=device)
        else:
            raise ValueError(f"{name}: unknown initialiser {kind!r}")
    return out
