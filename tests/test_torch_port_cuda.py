"""The CUDA kernels ``msda_forward`` and ``msda_backward`` against their
plain PyTorch versions, on a CUDA card. Without one, every test here skips
(the kernels have no CPU mode).

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
                                        ms_deform_attn_torch_vjp,
                                        msda_backward, msda_forward)

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


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain_vjp(cuda, value_dtype):
    """d_value, d_loc, d_attn against autograd through the plain version.
    f32: within 1e-5 of each gradient's largest entry (d_value is summed
    with atomics in a varying order; d_loc carries the level width as a
    factor). The kernel gives all three in f32. bf16 value: the plain
    d_value is rounded once to bf16, 1e-2 of its largest entry; d_loc and
    d_attn are f32 sums of the same inputs."""
    value, shapes, loc, attn = _inputs(cuda, 7, value_dtype=value_dtype)
    grad_out = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)).to(cuda, value_dtype)
    before = ms_deform_attn.backward_launches
    got = msda_backward(value, shapes, loc, attn, grad_out)
    assert ms_deform_attn.backward_launches == before + 1
    want = ms_deform_attn_torch_vjp(value, shapes, loc, attn, grad_out)
    torch.cuda.synchronize()
    assert all(g.dtype == torch.float32 for g in got)
    for i, (g, w) in enumerate(zip(got, want)):
        rel = 1e-2 if (i == 0 and value_dtype == torch.bfloat16) else 1e-5
        tol = rel * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol, i


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_cuda_output_carries_grad_fn(cuda, value_dtype):
    """A CUDA output that requires grad has a grad_fn, and backward
    launches the backward kernel: the gradients reach value, loc and
    attn, each in its input's dtype (autograd casts the kernel's f32
    d_value for a bf16 value)."""
    value, shapes, loc, attn = _inputs(cuda, 9, value_dtype=value_dtype)
    for t in (value, loc, attn):
        t.requires_grad_(True)
    before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
    out = ms_deform_attn(value, shapes, loc, attn)
    assert out.requires_grad and out.grad_fn is not None
    (out.float() ** 2).sum().backward()
    assert (ms_deform_attn.launches,
            ms_deform_attn.backward_launches) == (before[0] + 1,
                                                  before[1] + 1)
    for t in (value, loc, attn):
        assert t.grad is not None and t.grad.dtype == t.dtype
        assert torch.isfinite(t.grad).all()
        assert t.grad.abs().sum().item() > 0


def test_tiny_train_step_cuda_matches_cpu(cuda):
    """One f32 train step of the tiny model (dropout 0): the loss and the
    updated parameters on the card (kernels) against the CPU (plain)."""
    from snipper_tpu_torch.data.snippet import stack_batch
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import batch_to_device, train_step

    cfg = Config.tiny().replace(dropout=0.0, batch_size=2)
    ds = SyntheticDataset(cfg, n_samples=2, seed=0)
    host = stack_batch([ds[0], ds[1]])
    m_cpu = build_model(cfg, device="cpu", seed=1)
    m_gpu = build_model(cfg, device=cuda, seed=1)
    res = {}
    for dev, model in ((torch.device("cpu"), m_cpu), (cuda, m_gpu)):
        state = create_train_state(cfg, model, steps_per_epoch=10)
        metrics = train_step(state, SetCriterion(cfg),
                             batch_to_device(host, dev),
                             torch.Generator().manual_seed(0),
                             mixed_precision=False)
        res[dev.type] = (metrics["loss_total"].item(),
                         {k: v.detach().cpu()
                          for k, v in model.state_dict().items()})
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-4 * abs(res["cpu"][0])
    for k, v in res["cpu"][1].items():
        torch.testing.assert_close(res["cuda"][1][k], v, rtol=1e-4,
                                   atol=1e-5, msg=k)

