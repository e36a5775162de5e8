"""3D (t, y, x) sinusoidal position encoding.

Counterpart of ``snipper_tpu/models/position_encoding.py``: cumulative-sum
embeddings over the frame, row and column axes of the non-padded mask,
each normalized to ``[0, 2*pi]`` and expanded into ``num_pos_feats``
sin/cos features; the channel order is ``(z, y, x)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def position_encoding_3d(mask: torch.Tensor, num_pos_feats: int,
                         temperature: float = 10000.0) -> torch.Tensor:
    """``mask [B, T, h, w]`` bool (True on padded pixels) ->
    ``[B, T, h, w, 3 * num_pos_feats]``."""
    scale = 2 * math.pi
    not_mask = (~mask).float()
    z_embed = not_mask.cumsum(1)
    y_embed = not_mask.cumsum(2)
    x_embed = not_mask.cumsum(3)
    eps = 1e-6
    z_embed = z_embed / (z_embed[:, -1:, :, :] + eps) * scale
    y_embed = y_embed / (y_embed[:, :, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)

    def _feat(e):
        p = e[..., None] / dim_t                      # [B, T, h, w, F]
        # interleave sin(even) / cos(odd); for odd F pad to even,
        # interleave and slice back (position_encoding.py:55-60)
        if p.shape[-1] % 2:
            p = F.pad(p, (0, 1))
        out = torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()), dim=-1)
        return out.flatten(-2)[..., :num_pos_feats]

    return torch.cat((_feat(z_embed), _feat(y_embed), _feat(x_embed)), -1)
