"""Rounding of the operands of every matrix product and convolution in the
plain reference.

``float32`` leaves them as they are: the reference's own precision, with
TF32 off. The two controls stand for the step below a configuration's
precision, the one a later change would be tempted to take:

- ``tf32``: each operand rounded to TF32 (10 explicit mantissa bits, to
  nearest with ties away from zero, as ``cvt.rna.tf32.f32``), the product
  summed in f32: what cuBLAS and cuDNN compute with TF32 allowed. The
  control of an f32 configuration.
- ``fp8``: the control of the bf16 training recipe, which computes the
  network and its backward in bf16 and the criterion in f32. Every operand
  of a product, and inside :meth:`Precision.everywhere` (the network's
  forward and the backward) the result of every operation, is scaled by
  its largest magnitude over 448 and rounded to ``float8_e4m3fn``:
  per-tensor scaled fp8 in place of bf16. The operands' rounding passes
  gradients unchanged (straight through).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

KINDS = ("float32", "tf32", "fp8")
FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).view(x.shape)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (y - x).detach()


class Precision:
    """``q(t)``: an operand of a product in this precision."""

    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"unknown precision {kind!r}; one of {KINDS}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "tf32":
            return t + (round_tf32(t.detach()) - t).detach()
        if self.kind == "fp8":
            return round_fp8(t)
        return t

    def everywhere(self):
        """A context in which ``fp8`` rounds the result of every operation;
        nothing for the other precisions."""
        return _RoundResults() if self.kind == "fp8" else \
            contextlib.nullcontext()


# results left as they are: uninitialised memory, and ratios, whose
# small values a log reads (inverse_sigmoid: the smallest ratios of a
# tensor scaled to its largest would underflow to 0)
KEEP = ("empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "div")


class _RoundResults(TorchDispatchMode):
    """Rounds every f32 result to per-tensor scaled fp8; a result written
    in place is rounded in place; the results of ``KEEP`` are left."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] in KEEP:
            return out
        inputs = {id(a) for a in args if isinstance(a, torch.Tensor)}

        def rnd(t):
            if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and t.numel()):
                return t
            y = round_fp8(t)
            if id(t) in inputs:
                return t.copy_(y)
            return y

        return tree_map(rnd, out)
