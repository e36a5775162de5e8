"""Snipper: single-stage spatiotemporal transformer for multi-person 3D pose
estimation, tracking and forecasting.

Counterpart of ``snipper_tpu/models/snipper.py`` with the same public
layout: images ``[B, T, H, W, 3]`` in [0, 1], an optional pad mask
``[B, T, H, W]`` (True = pad), and the same output-dict keys. Module and
parameter names follow the flax tree, so ``convert.state_dict_from_jax``
is a plain walk with transposes. The forward's four stages run in host
spans (``record_function``): ``model.backbone`` (with the input
projections and the position encodings), ``model.encoder`` and
``model.decoder`` (``models/transformer.py``), ``model.heads``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.models.init import fill_, init_weights
from snipper_tpu_torch.models.position_encoding import position_encoding_3d
from snipper_tpu_torch.models.resnet import RESNET_SPECS, ResNet
from snipper_tpu_torch.models.transformer import DeformableTransformer

BACKBONE_CHANNELS = (512, 1024, 2048)


class InputProj(nn.Module):
    """1x1 conv + GroupNorm(32) level projection (reference
    ``models/model.py:67-89``); stride-2 3x3 for extra pyramid levels."""

    def __init__(self, cin: int, hidden_dim: int, stride2: bool = False):
        super().__init__()
        if stride2:
            self.conv = nn.Conv2d(cin, hidden_dim, 3, stride=2, padding=1)
        else:
            self.conv = nn.Conv2d(cin, hidden_dim, 1)
        self.norm = nn.GroupNorm(32, hidden_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.conv(x))


class Snipper(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_dim
        self.backbone = ResNet(RESNET_SPECS[cfg.backbone])
        n_taps = len(BACKBONE_CHANNELS)
        for lvl in range(min(cfg.num_feature_levels, n_taps)):
            setattr(self, f"input_proj{lvl}",
                    InputProj(BACKBONE_CHANNELS[lvl], C))
        cin = BACKBONE_CHANNELS[-1]
        for lvl in range(n_taps, cfg.num_feature_levels):
            setattr(self, f"input_proj{lvl}", InputProj(cin, C, stride2=True))
            cin = C
        self.query_embed = nn.Parameter(
            torch.empty(cfg.num_queries * cfg.total_frames, 2 * C))
        self.transformer = DeformableTransformer(
            d_model=C, n_heads=cfg.nheads,
            num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers,
            dim_feedforward=cfg.dim_feedforward,
            num_feature_levels=cfg.num_feature_levels,
            enc_n_points=cfg.enc_n_points, dec_n_points=cfg.dec_n_points,
            n_frames=cfg.num_frames, n_future_frames=cfg.num_future_frames,
            num_keypoints=cfg.num_kpts, dropout=cfg.dropout,
            impl=cfg.deform_impl, sample_dtype=cfg.deform_dtype)
        # heads shared across decoder layers (reference models/model.py:93-104)
        self.class_embed = nn.Linear(C, 2)
        for j in range(cfg.num_kpts - 1):
            setattr(self, f"joint_embed{j}", nn.Linear(C, 4))

    def init_own_weights(self, generator):
        fill_(self.query_embed, "normal", generator)

    def forward(self, images: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                return_attn: bool = False):
        cfg = self.cfg
        B, T, H, W, _ = images.shape
        if T != cfg.num_frames:
            raise ValueError(f"got {T} frames, config has {cfg.num_frames}")
        C = cfg.hidden_dim

        with record_function("model.backbone"):
            # ---- backbone on folded frames (NHWC memory, NCHW logical) ----
            x = images.reshape(B * T, H, W, 3).permute(0, 3, 1, 2)
            taps = self.backbone(x)

            # ---- input projections + extra levels -------------------------
            srcs: List[torch.Tensor] = []
            for lvl in range(min(cfg.num_feature_levels, len(taps))):
                srcs.append(getattr(self, f"input_proj{lvl}")(taps[lvl]))
            extra_src = taps[-1]
            for lvl in range(len(taps), cfg.num_feature_levels):
                extra_src = getattr(self, f"input_proj{lvl}")(extra_src)
                srcs.append(extra_src)
            srcs = [s.permute(0, 2, 3, 1) for s in srcs]   # [B*T, h, w, C]

            # ---- masks + position encodings per level ---------------------
            masks, pos_embeds = [], []
            for src in srcs:
                _, h, w, _ = src.shape
                if mask is not None:
                    # nearest downsample with torch's floor convention
                    # src = floor(dst * in / out) (snipper.py:77-84)
                    iy = torch.arange(h, device=mask.device) * H // h
                    ix = torch.arange(w, device=mask.device) * W // w
                    m = mask[:, :, iy][:, :, :, ix]
                else:
                    m = torch.zeros(B, T, h, w, dtype=torch.bool,
                                    device=images.device)
                masks.append(m)
                pe = position_encoding_3d(m, C // 3)
                if pe.shape[-1] != C:  # hidden_dim not divisible by 3: pad
                    pe = F.pad(pe, (0, C - pe.shape[-1]))
                pos_embeds.append(pe.to(src.dtype))
            srcs = [s.reshape(B, T, *s.shape[1:]) for s in srcs]

        # ---- transformer ---------------------------------------------------
        tr = self.transformer(srcs, masks if mask is not None else None,
                              pos_embeds, self.query_embed,
                              return_attn=return_attn)

        with record_function("model.heads"):
            # ---- heads -----------------------------------------------------
            hs = tr["hs"]                    # [nl, B, T1, q, C]
            roots_raw = tr["roots_raw"]      # [nl, B, T1, q, 4]
            nl = hs.shape[0]
            logits = self.class_embed(hs).transpose(2, 3)  # [nl, B, q, T1, 2]
            roots = torch.sigmoid(roots_raw).transpose(2, 3)[..., None, :]
            joints = torch.stack(
                [getattr(self, f"joint_embed{j}")(hs)
                 for j in range(cfg.num_kpts - 1)], dim=-2)
            joints = joints.transpose(2, 3)          # [nl, B, q, T1, K-1, 4]
            kpts = torch.cat([roots, joints], dim=-2)  # [nl, B, q, T1, K, 4]

            out = {
                "pred_logits": logits[-1],       # [B, q, T1, 2]
                "pred_kpts2d": kpts[-1, ..., 0:3],
                "pred_depth": kpts[-1, ..., 3:4],
                "heatmaps": tr["heatmaps"],      # [(B, T, h, w, nhead, K)]
            }
            if cfg.aux_loss and nl > 1:
                out["aux_logits"] = logits[:-1]
                out["aux_kpts2d"] = kpts[:-1, ..., 0:3]
                out["aux_depth"] = kpts[:-1, ..., 3:4]
            out["init_reference"] = tr["init_reference"]
            out["references"] = tr["references"]
            out["sampling_overflow"] = tr["sampling_overflow"]
        if return_attn:
            out["attn_data"] = tr["attn_data"]
        return out


def resolve_device(device="cuda") -> torch.device:
    """The device to run on: CUDA unless the caller asks for the CPU.
    Raises when CUDA is asked for and absent; never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: snipper_tpu_torch runs on the GPU by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def build_model(cfg: Config, device="cuda", seed: int = 0) -> Snipper:
    """A ``Snipper`` in eval mode on ``device`` with seeded random weights
    (load a checkpoint over them with ``load_state_dict``)."""
    cfg.validate()
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Snipper(cfg)
    model.to_empty(device=dev)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


def bf16_params(tensors: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The port's one bf16 recipe, the counterpart of JAX's ``bf16_params``
    (``scripts/probe.py:89-94``; the same cast in ``bench.py:127-129``,
    ``snipper_tpu/train/step.py:91-94`` and ``cli/export.py:82-87``):
    every f32 tensor of ``tensors`` (a state dict, or a module's parameters
    and buffers) cast to bf16, every other as it is.

    The port's state dict holds exactly the leaves of JAX's ``params``
    tree, under ``convert.state_dict_from_jax``'s names: the frozen-BN
    statistics are parameters there (``snipper_tpu/models/resnet.py:
    38-41``) and buffers here, and both recipes cast them. The cast keeps
    autograd: the gradient of a bf16 copy reaches its f32 master."""
    return {k: t.to(torch.bfloat16) if t.dtype == torch.float32 else t
            for k, t in tensors.items()}


def bf16_model(model: nn.Module) -> nn.Module:
    """``model`` with its weights replaced, in place, by their
    :func:`bf16_params` copies (made once; the forward then runs in bf16
    on a bf16 input, as JAX's ``apply`` on ``bf16_params``). Returns
    ``model``."""
    state = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, t in bf16_params(state).items():
            if t is not state[name]:
                state[name].data = t
    return model
