"""Checkpoints of the port's trainer, and the torchvision backbone import.

Counterpart of ``snipper_tpu/train/checkpoint.py:24-63``: one file per
epoch, ``{ckpt_dir}/checkpoint{epoch:04d}.pt``, holding the JAX CLI's keys
(``cli/train.py:164-166``): ``params`` (the model's ``state_dict``),
``opt_state`` (``TrainState.state_dict``) and ``step``. It is written with
``torch.save`` in the port's own format, as the JAX package writes its
own; the original repository's ``.pth`` is read by
``convert.load_reference_checkpoint`` and not written. The newest ``keep``
files are kept; ``latest_checkpoint`` backs ``--resume auto``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from snipper_tpu_torch.convert import reference_key_map

_NAME = re.compile(r"checkpoint\d{4}\.pt")


def save_checkpoint(ckpt_dir: str, state: Dict, epoch: int,
                    keep: int = 100) -> str:
    """Write ``state`` (``{"params", "opt_state", "step"}``) for ``epoch``
    (to a temporary name, then renamed, so a reader never sees half a
    file); delete all but the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir),
                        f"checkpoint{epoch:04d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    existing = sorted(d for d in os.listdir(ckpt_dir) if _NAME.fullmatch(d))
    for stale in existing[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, stale))
    return path


def load_checkpoint(path: str) -> Dict:
    """Read a checkpoint written by :func:`save_checkpoint` onto the
    CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest ``checkpointNNNN.pt`` under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    existing = sorted(d for d in os.listdir(ckpt_dir) if _NAME.fullmatch(d))
    return os.path.join(ckpt_dir, existing[-1]) if existing else None


def torchvision_key_map(cfg) -> Dict[str, str]:
    """Raw torchvision ResNet key (``conv1.weight``,
    ``layer1.0.conv1.weight``, ...) -> the port's backbone key: the
    backbone part of ``convert.reference_key_map`` without its
    ``backbone.0.body.`` prefix."""
    prefix = "backbone.0.body."
    return {k[len(prefix):]: v for k, v in reference_key_map(cfg).items()
            if k.startswith(prefix)}


def load_torchvision_backbone(model: torch.nn.Module, path: str, cfg,
                              strict: bool = True) -> int:
    """Load a torchvision ResNet ``.pth`` into the model's backbone (the
    reference's ImageNet start, ``models/backbone.py:107``; the classifier
    ``fc.*`` is ignored). With ``strict``, an unmapped key or a missing
    backbone key raises. Returns the number of tensors loaded."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    key_map = torchvision_key_map(cfg)
    out = {}
    for k, v in sd.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        if k not in key_map:
            if strict:
                raise KeyError(f"unmapped torchvision key: {k}")
            continue
        out[key_map[k]] = v
    if strict:
        missing = set(key_map.values()) - set(out)
        if missing:
            raise KeyError(f"missing torchvision keys for: "
                           f"{sorted(missing)[:10]} "
                           f"(+{max(0, len(missing) - 10)} more)")
    own = model.state_dict()
    with torch.no_grad():
        for k, v in out.items():
            own[k].copy_(v)
    return len(out)
