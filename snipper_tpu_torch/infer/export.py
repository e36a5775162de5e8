"""Serving export: the forward as a self-contained ``torch.export`` artifact.

The port's counterpart of ``snipper_tpu/infer/export.py``. The reference
serves by loading its whole code base and a checkpoint
(``inference.py:129-135``); here ``torch.export`` traces the model's
forward, weights included, into an ``ExportedProgram`` that
``torch.export.save`` writes to one file. A server reads it back with
:func:`load_exported` and calls it on ``images [B, T, H, W, 3]`` float32
in [0, 1]. The outputs are what PostProcess reads: ``pred_logits``,
``pred_kpts2d``, ``pred_depth``, ``heatmaps`` (for overlays) and
``sampling_overflow`` (a 0-d int32, always 0: the port's sampling is an
exact gather). The decoder's auxiliary outputs, the reference-point traces
and the attention data are train- and debug-time outputs and are left out.

Differences from the JAX package:

- The artifact holds a graph of PyTorch operators, among them one
  ``snipper_tpu_torch::msda_forward`` per sampling call. To run it, a
  server must have those operators registered, so :func:`load_exported`
  imports ``snipper_tpu_torch.ops.msda`` (the operators and their CUDA
  kernels, built at first use). It imports nothing of
  ``snipper_tpu_torch.models``: no model code is needed. JAX's artifact
  needs no code of the package at all.
- ``platforms`` names the one device the forward is traced on and runs on:
  ``["cuda"]`` (or ``["gpu"]``) or ``["cpu"]``. ``torch.export`` traces
  for one device, so one platform only, and there is no TPU.
- ``jit_call``: JAX wraps the call in ``jax.jit``. A loaded program here
  runs its graph op by op, launching the same kernels as the live model;
  ``jit_call=True`` (the default) runs each call under
  ``torch.inference_mode()``, ``False`` calls the program as it is.
- ``param_dtype="bfloat16"`` applies JAX's bf16 recipe once, before the
  trace (``models/snipper.py::bf16_params``): the artifact holds bf16
  weights (half the file) and computes in bf16 on the f32 images cast to
  bf16, so that no weight is widened inside the program. It takes f32
  images and returns JAX's bf16 artifact's dtypes: bf16 predictions, f32
  heatmaps. JAX's artifact, given f32 images, lets flax promote each
  product of an f32 activation and a bf16 weight to f32, so its backbone
  and encoder run in f32 on its bf16 weights and only the decoder's query
  path runs in bf16; the two agree within 4 bf16 units of each output's
  scale at tiny (``tests/test_torch_port_export.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

# the model's outputs that the artifact leaves out (JAX export.py:53-56)
DROP = ("aux_logits", "aux_kpts2d", "aux_depth", "init_reference",
        "references", "attn_data")
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def resolve_platform(platforms: Optional[Sequence[str]],
                     device: str = "cuda") -> str:
    """The device ``export_forward`` traces on: ``device``, or the one
    entry of ``platforms`` (``cuda``/``gpu`` or ``cpu``)."""
    if not platforms:
        return device
    names = [p.strip().lower() for p in platforms if p.strip()]
    if len(names) != 1:
        raise ValueError(f"torch.export traces for one device; got "
                         f"platforms {list(platforms)}")
    if names[0] not in _PLATFORMS:
        raise ValueError(f"platform {names[0]!r}: the port exports for "
                         f"cuda (gpu) or cpu")
    return _PLATFORMS[names[0]]


class ServingForward(nn.Module):
    """The model with the artifact's output dict, on f32 ``images``. With
    ``param_dtype`` bfloat16 the model's weights are cast to bf16 once,
    here (in place, by ``models/snipper.py::bf16_model``); the forward
    casts the images to bf16, runs the model in bf16 and returns the
    heatmaps in f32, as JAX's bf16 artifact does."""

    def __init__(self, model: nn.Module, param_dtype: str = "float32"):
        super().__init__()
        self.bf16 = param_dtype == "bfloat16"
        if self.bf16:
            from snipper_tpu_torch.models.snipper import bf16_model

            model = bf16_model(model)
        self.model = model

    def forward(self, images: torch.Tensor) -> Dict:
        out = self.model(images.to(torch.bfloat16) if self.bf16 else images)
        res = {k: v for k, v in out.items()
               if k not in DROP and k != "sampling_overflow"}
        if self.bf16:
            res["heatmaps"] = [h.float() for h in res["heatmaps"]]
        res["sampling_overflow"] = torch.full(
            (), int(out["sampling_overflow"]), dtype=torch.int32,
            device=images.device)
        return res


def export_forward(cfg, state_dict: Optional[Dict[str, torch.Tensor]],
                   batch_size: int = 1,
                   platforms: Optional[Sequence[str]] = None,
                   device: str = "cuda", param_dtype: str = "float32",
                   seed: int = 0) -> "torch.export.ExportedProgram":
    """Trace the forward of ``cfg``'s model with ``state_dict`` loaded (a
    model seeded with ``seed`` when it is None) into an
    ``ExportedProgram`` for ``images [batch_size, T, H, W, 3]`` f32 on the
    device that ``platforms`` or ``device`` names."""
    from snipper_tpu_torch.models.snipper import build_model

    dev = resolve_platform(platforms, device)
    model = build_model(cfg, device=dev, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    wrapper = ServingForward(model, param_dtype).eval()
    images = torch.zeros(batch_size, cfg.num_frames, cfg.input_height,
                         cfg.input_width, 3, dtype=torch.float32,
                         device=dev)
    with torch.no_grad():
        # one eager call first: it makes the small device constants of the
        # sampling (ops/deform_attn.py::device_constant), which the trace
        # then holds on the device
        wrapper(images)
        return torch.export.export(wrapper, (images,), strict=False)


def save_exported(exported, path: str) -> int:
    """Write ``exported`` to ``path``; returns the artifact's size in
    bytes."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_exported(path: str, jit_call: bool = True):
    """Read an artifact; returns ``run(images) -> output dict``. ``images``
    may be a numpy array or a tensor; it goes to the program's device.
    Imports the MSDA operators and nothing of the model's modules."""
    import snipper_tpu_torch.ops.msda  # noqa: F401 (registers the ops)

    exported = torch.export.load(path)
    module = exported.module()
    # the weights lie on the device the program was traced on
    device = next(iter(exported.state_dict.values())).device

    def run(images):
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images, np.float32))
        images = images.to(device)
        if jit_call:
            with torch.inference_mode():
                return module(images)
        return module(images)

    run.exported = exported
    run.device = device
    return run
