"""The CUDA kernel ``msda_forward`` against its plain PyTorch version, on a
CUDA card. Without one, every test here skips (the kernel has no CPU
mode).

This file imports nothing of JAX, so it also runs on a GPU host without
JAX (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.ops.msda import (ms_deform_attn, ms_deform_attn_torch,
                                        msda_forward)

SHAPES = [(6, 9), (3, 5), (2, 2)]
CANONICAL = [(75, 100), (38, 50), (19, 25)]   # 600x800 at strides 8/16/32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The CUDA device, with TF32 off for the comparisons."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _inputs(device, seed, shapes=SHAPES, value_dtype=torch.float32, B=2,
            NH=4, D=8, LQ=37, P=3):
    """Locations in [-0.1, 1.1], so corners fall off the map."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    v = rng.standard_normal((B, S, NH, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, LQ, NH, L, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, LQ, NH, L, P)).astype(np.float32)
    return (torch.from_numpy(v).to(device, value_dtype), shapes,
            torch.from_numpy(loc).to(device), torch.from_numpy(w).to(device))


@pytest.mark.parametrize("shapes,D,LQ,P", [(SHAPES, 8, 37, 3),
                                           (CANONICAL, 48, 200, 4)])
def test_kernel_matches_plain_f32(cuda, shapes, D, LQ, P):
    args = _inputs(cuda, 4, shapes, D=D, LQ=LQ, P=P)
    before = ms_deform_attn.launches
    got = ms_deform_attn(*args)
    assert ms_deform_attn.launches == before + 1
    want = ms_deform_attn_torch(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_kernel_matches_plain_bf16_value(cuda):
    """bf16 value, f32 accumulation, one rounding to bf16 at the end:
    within 1e-2 of the largest output."""
    args = _inputs(cuda, 5, value_dtype=torch.bfloat16)
    got = msda_forward(*args)
    want = ms_deform_attn_torch(*args)
    assert got.dtype == torch.bfloat16
    tol = 1e-2 * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    value, shapes, loc, attn = _inputs(cuda, 6)
    with pytest.raises(TypeError):
        msda_forward(value.half(), shapes, loc, attn)
    strided = loc.transpose(1, 2).contiguous().transpose(1, 2)
    assert strided.shape == loc.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        msda_forward(value, shapes, strided, attn)
    with pytest.raises(ValueError):
        msda_forward(value, shapes[:2], loc, attn)


def test_tiny_model_cuda_matches_cpu(cuda):
    """The tiny model on the card (kernel) against the CPU (plain)."""
    cfg = Config.tiny()
    m_cpu = build_model(cfg, device="cpu", seed=1)
    with torch.no_grad():
        for name, p in m_cpu.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.normal_(0, 0.05, generator=torch.Generator().manual_seed(2))
    m_gpu = build_model(cfg, device=cuda, seed=1)
    m_gpu.load_state_dict(m_cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (1, cfg.num_frames, cfg.input_height, cfg.input_width, 3)
    ).astype(np.float32))
    before = ms_deform_attn.launches
    with torch.inference_mode():
        got = m_gpu(x.to(cuda))
        want = m_cpu(x)
    assert ms_deform_attn.launches == before + cfg.enc_layers + cfg.dec_layers
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3,
                                   atol=1e-4)
