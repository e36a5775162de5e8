"""Weight conversion into the port's ``state_dict``.

- :func:`state_dict_from_jax`: the JAX package's flax parameter tree (nested
  dicts of numpy arrays) -> the port's names and layouts. The port's module
  names follow the flax tree, so this is a walk with transposes: Dense
  kernels ``[in, out]`` become ``[out, in]``, convolution kernels HWIO
  become OIHW, norm ``scale`` becomes ``weight``.
- :func:`state_dict_from_reference`: a checkpoint of the original Snipper
  repository (``.pth`` names) -> the port's names. The tensors already have
  torch layouts, so only the names change. The key map is the port's own
  copy of the JAX package's ``torch_key_map``
  (``snipper_tpu/train/checkpoint.py:77-195``), with its alias rules.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from snipper_tpu_torch.models.resnet import RESNET_SPECS


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = prefix + (k,)
            if isinstance(v, dict):
                walk(v, path)
                continue
            a = _to_numpy(v)
            name = k
            if k == "kernel":
                name = "weight"
                if a.ndim == 2:                     # Dense [in, out]
                    a = a.T
                elif a.ndim == 4:                   # Conv HWIO -> OIHW
                    a = a.transpose(3, 2, 0, 1)
                else:
                    raise ValueError(f"kernel of rank {a.ndim} at {path}")
            elif k == "scale":
                name = "weight"
            key = ".".join(prefix + (name,))
            out[key] = torch.from_numpy(np.array(a, order="C"))

    walk(params, ())
    return out


def reference_key_map(cfg) -> Dict[str, str]:
    """Original-repo state-dict key -> port key. Modules that the original
    repeats as aliases (per-frame offset/weight Linears, per-layer heads)
    are read from index 0."""
    m: Dict[str, str] = {}

    def bn(src, dst):
        for k in ("weight", "bias", "running_mean", "running_var"):
            m[f"{src}.{k}"] = f"{dst}.{k}"

    B = "backbone.0.body"
    m[f"{B}.conv1.weight"] = "backbone.conv1.weight"
    bn(f"{B}.bn1", "backbone.bn1")
    layers = RESNET_SPECS[cfg.backbone]
    for s in range(4):
        for b in range(layers[s]):
            src = f"{B}.layer{s + 1}.{b}"
            dst = f"backbone.layer{s + 1}_{b}"
            for c in (1, 2, 3):
                m[f"{src}.conv{c}.weight"] = f"{dst}.conv{c}.weight"
                bn(f"{src}.bn{c}", f"{dst}.bn{c}")
            if b == 0:
                m[f"{src}.downsample.0.weight"] = \
                    f"{dst}.downsample_conv.weight"
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")

    for lvl in range(cfg.num_feature_levels):
        src, dst = f"input_proj.{lvl}", f"input_proj{lvl}"
        for k in ("weight", "bias"):
            m[f"{src}.0.{k}"] = f"{dst}.conv.{k}"
            m[f"{src}.1.{k}"] = f"{dst}.norm.{k}"

    m["query_embed.weight"] = "query_embed"
    for k in ("weight", "bias"):
        m[f"class_embed.0.{k}"] = f"class_embed.{k}"
        m[f"root_embed.0.layers.0.{k}"] = f"transformer.root_embed.{k}"
        for j in range(cfg.num_kpts - 1):
            m[f"joint_embed.0.{j}.layers.0.{k}"] = f"joint_embed{j}.{k}"

    TR = "transformer"
    m[f"{TR}.level_embed"] = f"{TR}.level_embed"
    m[f"{TR}.temporal_embed"] = f"{TR}.temporal_embed"
    for k in ("weight", "bias"):
        m[f"{TR}.reference_points.{k}"] = f"{TR}.reference_points.{k}"

    def deform_attn(src, dst):
        for k in ("weight", "bias"):
            m[f"{src}.sampling_offsets.0.{k}"] = f"{dst}.sampling_offsets.{k}"
            m[f"{src}.attention_weights.0.{k}"] = \
                f"{dst}.attention_weights.{k}"
            for p in ("value_proj", "output_proj"):
                m[f"{src}.{p}.{k}"] = f"{dst}.{p}.{k}"

    def norms_ffn(src, dst, norm_ids):
        for k in ("weight", "bias"):
            for n in norm_ids:
                m[f"{src}.norm{n}.{k}"] = f"{dst}.norm{n}.{k}"
            for lin in ("linear1", "linear2"):
                m[f"{src}.{lin}.{k}"] = f"{dst}.{lin}.{k}"

    for i in range(cfg.enc_layers):
        src, dst = f"{TR}.encoder.layers.{i}", f"{TR}.encoder_layer{i}"
        deform_attn(f"{src}.self_attn", f"{dst}.self_attn")
        norms_ffn(src, dst, (1, 2))
    for i in range(cfg.dec_layers):
        src, dst = f"{TR}.decoder.layers.{i}", f"{TR}.decoder_layer{i}"
        deform_attn(f"{src}.cross_attn", f"{dst}.cross_attn")
        for k in ("in_proj_weight", "in_proj_bias", "out_proj.weight",
                  "out_proj.bias"):
            m[f"{src}.self_attn.{k}"] = f"{dst}.self_attn.{k}"
        norms_ffn(src, dst, (1, 2, 3))
    return m


# keys that exist in original-repo checkpoints but are aliases or ignored
_IGNORED = re.compile(
    r"(num_batches_tracked$"
    r"|^(class_embed|root_embed|joint_embed)\.[1-9]\d*\."   # per-layer alias
    r"|\.sampling_offsets\.[1-9]\d*\."                      # per-frame alias
    r"|\.attention_weights\.[1-9]\d*\."
    r"|^transformer\.decoder\.(root_embed|class_embed)\.)"  # decoder alias
)


def state_dict_from_reference(sd: Dict[str, Any], cfg,
                              strict: bool = True) -> Dict[str, torch.Tensor]:
    """Rename an original-repo ``model`` state dict to the port's keys.
    With ``strict``, an unmapped key or a missing mapped key raises."""
    key_map = reference_key_map(cfg)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if _IGNORED.search(k):
            continue
        if k not in key_map:
            if strict:
                raise KeyError(f"unmapped reference key: {k}")
            continue
        out[key_map[k]] = torch.as_tensor(_to_numpy(v)).clone()
    if strict:
        missing = set(key_map.values()) - set(out)
        if missing:
            raise KeyError(f"missing reference keys for: "
                           f"{sorted(missing)[:10]} "
                           f"(+{max(0, len(missing) - 10)} more)")
    return out


def load_reference_checkpoint(path: str, cfg,
                              strict: bool = True) -> Dict[str, torch.Tensor]:
    """Read an original-repo ``.pth`` (``{"model": state_dict}`` or a bare
    state dict) and rename it to the port's keys."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return state_dict_from_reference(ckpt.get("model", ckpt), cfg,
                                     strict=strict)
