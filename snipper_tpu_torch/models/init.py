"""Seeded parameter init with the JAX package's initializers.

Modules are built on the ``meta`` device, moved to their device empty, and
filled here from one ``torch.Generator`` on the CPU, so a seed gives the
same weights on every device. Each ``nn.Linear``/``nn.Conv2d`` carries the
flax initializer of its counterpart in ``weight_init``/``bias_init``
(default ``lecun`` and ``zeros``, flax's ``nn.Dense``/``nn.Conv``
defaults); a module with parameters of its own defines
``init_own_weights(generator)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def tag(module: nn.Module, weight="lecun", bias="zeros") -> nn.Module:
    """Record the flax initializers of a Linear or Conv2d. ``weight`` and
    ``bias`` are ``"lecun"``, ``"xavier"``, ``"zeros"``, ``"normal"`` or a
    numpy array of the parameter's size."""
    module.weight_init = weight
    module.bias_init = bias
    return module


def _fans(shape):
    # torch layouts: Linear [out, in], Conv [out, in, kh, kw], 2-D embeds
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def sample(shape, kind, generator: torch.Generator) -> torch.Tensor:
    """A CPU f32 tensor of ``shape`` drawn with flax initializer ``kind``."""
    shape = tuple(shape)
    if isinstance(kind, np.ndarray):
        return torch.from_numpy(kind.astype(np.float32).reshape(shape))
    if kind == "zeros":
        return torch.zeros(shape)
    if kind == "ones":
        return torch.ones(shape)
    if kind == "normal":
        return torch.empty(shape).normal_(0.0, 1.0, generator=generator)
    fan_in, fan_out = _fans(shape)
    if kind == "xavier":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape).uniform_(-a, a, generator=generator)
    if kind == "lecun":
        # flax lecun_normal: truncated normal at +-2 std, variance 1/fan_in
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        u = torch.empty(shape).uniform_(lo, 1 - lo, generator=generator)
        return torch.erfinv(2 * u - 1) * math.sqrt(2) * std
    raise ValueError(f"unknown initializer {kind!r}")


@torch.no_grad()
def fill_(tensor: torch.Tensor, kind, generator: torch.Generator):
    tensor.copy_(sample(tensor.shape, kind, generator))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fill_(mod.weight, getattr(mod, "weight_init", "lecun"), generator)
            if mod.bias is not None:
                fill_(mod.bias, getattr(mod, "bias_init", "zeros"),
                      generator)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        if hasattr(mod, "init_own_weights"):
            mod.init_own_weights(generator)
    return model
