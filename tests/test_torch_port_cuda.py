"""The CUDA kernels ``msda_forward``, ``msda_backward``, ``win2d_sample``,
``win2d_contract``, ``hier_gather``, ``chain_gather``, ``chain_select`` and
``lsa_rows`` against their plain PyTorch versions, the two MSDA kernels
through their registered operators, the f32-value kernels inside a bf16
step (``deform_dtype="float32"``), an exported artifact on the card
against the live model, and the device warps, ``cli.infer --device_preprocess``,
``cli.eval``, a train step from raw frames and the side-stream prefetch on
the card against the CPU, on a CUDA card. Without one, every test here
skips (the kernels have no CPU mode).

This file imports nothing of JAX, so it also runs on a GPU host without
JAX (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.ops import lane_chain, win2d
from snipper_tpu_torch.ops.lsa import lsa_rows, lsa_rows_torch
from snipper_tpu_torch.ops.deform_attn import (ms_deform_attn_windowed2d,
                                               windowed2d_plan)
from snipper_tpu_torch.ops.msda import (flat_shapes, ms_deform_attn,
                                        ms_deform_attn_torch,
                                        ms_deform_attn_torch_vjp,
                                        msda_backward, msda_forward)
from snipper_tpu_torch.scripts.lanegather_probe import _fixture

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
    in another order; d_loc carries the level width as a factor). d_value
    comes in the value's dtype, d_loc and d_attn in f32. bf16 value: both
    d_values are an f32 sum rounded once to bf16, 1e-2 of the largest
    entry; d_loc and d_attn are f32 sums of the same inputs."""
    value, shapes, loc, attn = _inputs(cuda, 7, value_dtype=value_dtype)
    grad_out = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)).to(cuda, value_dtype)
    before = ms_deform_attn.backward_launches
    got = msda_backward(value, shapes, loc, attn, grad_out)
    assert ms_deform_attn.backward_launches == before + 1
    want = ms_deform_attn_torch_vjp(value, shapes, loc, attn, grad_out)
    torch.cuda.synchronize()
    assert [g.dtype for g in got] == [value_dtype] + [torch.float32] * 2
    for i, (g, w) in enumerate(zip(got, want)):
        rel = 1e-2 if (i == 0 and value_dtype == torch.bfloat16) else 1e-5
        tol = rel * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol, i


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_cuda_output_carries_grad_fn(cuda, value_dtype):
    """A CUDA output that requires grad has a grad_fn, and backward
    launches the backward kernels: the gradients reach value, loc and
    attn, each in its input's dtype (the kernels write d_value in the
    value's)."""
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


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_registered_ops_match_plain(cuda, value_dtype):
    """Forward and backward through ``torch.ops.snipper_tpu_torch``'s
    ``msda_forward`` (its autograd formula calls ``msda_backward``) against
    the plain forward and VJP; the tolerances of
    test_kernel_matches_plain_f32 / _bf16_value and
    test_backward_kernel_matches_plain_vjp. Each op launches its kernel
    once."""
    value, shapes, loc, attn = _inputs(cuda, 10, value_dtype=value_dtype)
    grad_out = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)).to(cuda, value_dtype)
    inputs = [t.detach().clone().requires_grad_(True)
              for t in (value, loc, attn)]
    before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
    out = torch.ops.snipper_tpu_torch.msda_forward(
        inputs[0], flat_shapes(shapes), inputs[1], inputs[2])
    got = torch.autograd.grad(out, inputs, grad_out)
    assert (ms_deform_attn.launches,
            ms_deform_attn.backward_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want_out = ms_deform_attn_torch(value, shapes, loc, attn)
    want = ms_deform_attn_torch_vjp(value, shapes, loc, attn, grad_out)
    torch.cuda.synchronize()
    bf16 = value_dtype == torch.bfloat16
    scale = max(1.0, want_out.float().abs().max().item())
    tol = 1e-2 * scale if bf16 else 1e-5
    assert out.dtype == value_dtype
    assert (out.float() - want_out.float()).abs().max().item() <= tol
    for i, (g, w, t) in enumerate(zip(got, want, inputs)):
        assert g.dtype == t.dtype, i
        rel = 1e-2 if (i == 0 and bf16) else 1e-5
        tol = rel * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol, i


def test_exported_artifact_on_card_matches_live_model(cuda, tmp_path):
    """The tiny model exported on the card (``infer/export.py``), saved and
    loaded back: one ``msda_forward`` node per sampling call in its graph,
    that many launches per call, and the live model's outputs within 1e-5
    (the same kernels on the same inputs)."""
    from snipper_tpu_torch.infer.export import (export_forward,
                                                load_exported, save_exported)

    cfg = Config.tiny()
    model = build_model(cfg, device=cuda, seed=3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.normal_(0, 0.05, generator=torch.Generator(
                    device=cuda).manual_seed(4))
    ep = export_forward(cfg, model.state_dict(), device="cuda")
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and "snipper_tpu_torch.msda_forward" in str(n.target)]
    per_call = cfg.enc_layers + cfg.dec_layers
    assert len(nodes) == per_call
    path = str(tmp_path / "tiny.pt2")
    assert save_exported(ep, path) > 0
    run = load_exported(path)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (1, cfg.num_frames, cfg.input_height, cfg.input_width, 3)
    ).astype(np.float32)).to(cuda)
    before = ms_deform_attn.launches
    got = run(x)
    assert ms_deform_attn.launches - before == per_call
    with torch.inference_mode():
        want = model(x)
    assert int(got["sampling_overflow"]) == 0
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        assert got[k].device.type == "cuda"
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5)
    for a, b in zip(got["heatmaps"], want["heatmaps"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _msda_case(case, device, value_dtype):
    """(value, shapes, loc, attn, grad_out) for one path of the two MSDA
    kernels (``ops/csrc/msda_common.cuh``):

    - ``canonical_grid``: D = 48 at the canonical level shapes with
      encoder-style queries on every level's pixel grid (offsets of up to 4
      pixels), Lq = 9875, the 16-byte vector path;
    - ``far_off_map``: locations far off every map (1e9, -7.5, 3.0) among
      uniform ones in [-0.1, 1.1];
    - ``d6``: D = 6, no multiple of 4 or 8: the scalar path in both dtypes;
    - ``d12``: D = 12, the vector path in f32 and the scalar one in bf16;
    - ``d34``: D = 34 > 32 channels on the scalar path, two per lane;
    - ``misaligned``: value and grad_out 4 or 2 bytes off 16-byte
      alignment (contiguous views at an odd offset): the scalar path;
    - ``ragged``: Lq = 37, no multiple of any block's query run.
    """
    rng = np.random.default_rng(21)
    shapes, N, NH, D, LQ, P = {
        "canonical_grid": (CANONICAL, 1, 2, 48, 9875, 4),
        "far_off_map": (SHAPES, 2, 2, 8, 21, 2),
        "d6": (SHAPES, 2, 2, 6, 19, 2),
        "d12": (SHAPES, 2, 2, 12, 25, 3),
        "d34": (SHAPES, 2, 2, 34, 11, 3),
        "misaligned": (SHAPES, 2, 2, 16, 23, 2),
        "ragged": (SHAPES, 2, 4, 48, 37, 3),
    }[case]
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    if case == "canonical_grid":
        refs = []
        for h, w in shapes:
            gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                                 (np.arange(w) + 0.5) / w, indexing="ij")
            refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
        norm = np.array([(w, h) for h, w in shapes], np.float64)
        off = rng.uniform(-4, 4, (N, LQ, NH, L, P, 2))
        loc = (np.concatenate(refs, 0)[None, :LQ, None, None, None, :]
               + off / norm[None, None, None, :, None, :])
    else:
        loc = rng.uniform(-0.1, 1.1, (N, LQ, NH, L, P, 2))
    if case == "far_off_map":
        loc[0, 0, 0, 0, 0] = [1e9, -1e9]
        loc[1, 3, 1] = [-7.5, 3.0]
    v = rng.standard_normal((N, S, NH, D))
    w = rng.uniform(0, 1, (N, LQ, NH, L, P))
    g = rng.standard_normal((N, LQ, NH * D))

    def put(x, dtype):
        t = torch.from_numpy(x.astype(np.float32)).to(device, dtype)
        if case != "misaligned":
            return t
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    return (put(v, value_dtype), shapes,
            torch.from_numpy(loc.astype(np.float32)).to(device),
            torch.from_numpy(w.astype(np.float32)).to(device),
            put(g, value_dtype))


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["canonical_grid", "far_off_map", "d6",
                                  "d12", "d34", "misaligned", "ragged"])
def test_msda_kernel_paths_match_plain(cuda, case, value_dtype):
    """Both kernels on every path they choose from the sizes, against the
    plain forward and VJP: f32 within 1e-5 (forward absolute; each
    gradient of its largest entry); a bf16 value within 1e-2 of the
    largest output, and of the largest d_value entry (the plain VJP rounds
    it once to bf16), d_loc and d_attn within 1e-5."""
    value, shapes, loc, attn, grad_out = _msda_case(case, cuda, value_dtype)
    before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
    out = msda_forward(value, shapes, loc, attn)
    got = msda_backward(value, shapes, loc, attn, grad_out)
    assert (ms_deform_attn.launches,
            ms_deform_attn.backward_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want_out = ms_deform_attn_torch(value, shapes, loc, attn)
    want = ms_deform_attn_torch_vjp(value, shapes, loc, attn, grad_out)
    torch.cuda.synchronize()
    bf16 = value_dtype == torch.bfloat16
    assert out.dtype == value_dtype
    scale = max(1.0, want_out.float().abs().max().item())
    tol = 1e-2 * scale if bf16 else 1e-5
    assert (out.float() - want_out.float()).abs().max().item() <= tol
    assert [t.dtype for t in got] == [value_dtype] + [torch.float32] * 2
    for i, (g, w) in enumerate(zip(got, want)):
        rel = 1e-2 if (i == 0 and bf16) else 1e-5
        tol = rel * max(1.0, w.float().abs().max().item())
        assert torch.isfinite(g).all()
        assert (g.float() - w.float()).abs().max().item() <= tol, i


def _corner_case(device, value_dtype, shapes, N, NH, D, LQ, P, seed):
    """(value, loc, attn, grad_out, hit) with every tap's pixel coordinate
    x = u * w - 0.5 an integer k in [-1, w - 1] plus a fraction in
    [0.1, 0.9] (and so for y): no coordinate lies near a pixel's edge, so
    which corners are in the map is the same on every side, and corners
    fall off the left, right, top and bottom edges. ``hit`` [N, S, NH]
    marks the value rows some in-map corner falls on."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    loc = np.empty((N, LQ, NH, L, P, 2))
    hit = np.zeros((N, S, NH), bool)
    n_i = np.arange(N)[:, None, None, None]
    h_i = np.arange(NH)[None, None, :, None]
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        kx = rng.integers(-1, w, (N, LQ, NH, P))
        ky = rng.integers(-1, h, (N, LQ, NH, P))
        fx, fy = (rng.uniform(0.1, 0.9, (N, LQ, NH, P)) for _ in range(2))
        loc[:, :, :, lvl, :, 0] = (kx + fx + 0.5) / w
        loc[:, :, :, lvl, :, 1] = (ky + fy + 0.5) / h
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = kx + dx, ky + dy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                r = np.broadcast_to(start + y * w + x, ok.shape)
                hit[np.broadcast_to(n_i, ok.shape)[ok], r[ok],
                    np.broadcast_to(h_i, ok.shape)[ok]] = True
        start += h * w

    def put(x, dtype):
        return torch.from_numpy(x.astype(np.float32)).to(device, dtype)

    return (put(rng.standard_normal((N, S, NH, D)), value_dtype),
            put(loc, torch.float32),
            put(rng.uniform(0, 1, (N, LQ, NH, L, P)), torch.float32),
            put(rng.standard_normal((N, LQ, NH * D)), value_dtype),
            torch.from_numpy(hit).to(device))


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 6])
@pytest.mark.parametrize("kind", ["encoder", "decoder", "large_level"])
def test_backward_gather_matches_plain_vjp(cuda, kind, D, value_dtype):
    """The backward (the taps sorted on the card by cell and each value
    row summed by its owner) against the plain VJP, at an encoder-like
    shape (Lq = S), a decoder-like one (Lq much smaller than S) and one
    whose first level has more cells than the index kernel counts in
    shared memory (121 x 111 > 12288, ``MSDA_INDEX_SHARED_CELLS``, so its
    counters live in global memory; 2000 taps on 13431 cells, so cells
    share taps), on the vector path (D = 8) and the scalar one (D = 6),
    with corners off every edge: each gradient within 1e-5 of its largest
    entry, a bf16 d_value within one bf16 unit (both an f32 sum rounded
    once to bf16); rows no in-map corner falls on exactly zero; a second
    call bit-equal in all three outputs; each call counted once."""
    shapes, N, NH, LQ, P = {
        "encoder": (SHAPES, 2, 4, 73, 3),
        "decoder": ([(20, 30), (10, 15), (5, 8)], 2, 4, 5, 2),
        "large_level": ([(120, 110), (5, 8)], 1, 2, 500, 4),
    }[kind]
    value, loc, attn, grad_out, hit = _corner_case(
        cuda, value_dtype, shapes, N, NH, D, LQ, P, seed=31)
    assert value.shape[1] == LQ or kind != "encoder"
    before = ms_deform_attn.backward_launches
    got = msda_backward(value, shapes, loc, attn, grad_out)
    again = msda_backward(value, shapes, loc, attn, grad_out)
    want = ms_deform_attn_torch_vjp(value, shapes, loc, attn, grad_out)
    torch.cuda.synchronize()
    assert ms_deform_attn.backward_launches == before + 2
    assert [t.dtype for t in got] == [value_dtype] + [torch.float32] * 2
    bf16 = value_dtype == torch.bfloat16
    for i, (g, w) in enumerate(zip(got, want)):
        rel = 2.0 ** -7 if (i == 0 and bf16) else 1e-5
        tol = rel * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol, i
    # the encoder-like taps reach every row, the others leave rows untouched
    share = hit.float().mean().item()
    assert {"encoder": share == 1, "decoder": share < 0.2,
            "large_level": 0 < share < 1}[kind], share
    assert torch.count_nonzero(got[0][~hit]).item() == 0
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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



def test_tiny_bf16_step_float32_sampling_cuda_matches_cpu(cuda):
    """``deform_dtype="float32"`` in the tiny model's bf16 mixed-precision
    forward and backward (dropout 0, batch 2): on the card every sampling
    call launches the f32-value kernels, forward and backward, one of each
    per layer and no bf16-value one; held against the same step on the CPU
    (the plain MSDA): each prediction within ``BF16_BAR`` bf16 units of
    its scale, the loss within 1e-2 of its size and the gradients within
    ``GRAD_GAP`` of their norm. Both sides run bf16 matrix products, whose
    sums cuBLAS and the CPU order differently."""
    from snipper_tpu_torch.data.snippet import stack_batch
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.models.transformer import TemporalDeformAttn
    from snipper_tpu_torch.train.state import param_label
    from snipper_tpu_torch.train.step import batch_to_device, forward_loss

    BF16_BAR, GRAD_GAP = 4.0, 5e-2
    cfg = Config.tiny().replace(dropout=0.0, batch_size=2,
                                deform_dtype="float32")
    n_layers = cfg.enc_layers + cfg.dec_layers
    ds = SyntheticDataset(cfg, n_samples=2, seed=0)
    host = stack_batch([ds[0], ds[1]])
    m_cpu = build_model(cfg, device="cpu", seed=1)
    with torch.no_grad():
        for name, p in m_cpu.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.normal_(0, 0.05, generator=torch.Generator().manual_seed(2))
    m_gpu = build_model(cfg, device=cuda, seed=1)
    m_gpu.load_state_dict(m_cpu.state_dict())
    assert all(m.sample_dtype == "float32" for m in m_gpu.modules()
               if isinstance(m, TemporalDeformAttn))
    res = {}
    for dev, model in ((torch.device("cpu"), m_cpu), (cuda, m_gpu)):
        params = []
        for name, p in model.named_parameters():
            p.requires_grad_(param_label(name) != "frozen")
            if p.requires_grad:
                params.append(p)
        fwd = dict(ms_deform_attn.launches_by_dtype)
        bwd = dict(ms_deform_attn.backward_launches_by_dtype)
        total, _, out, _ = forward_loss(model.train(), SetCriterion(cfg),
                                        batch_to_device(host, dev), True)
        grads = torch.autograd.grad(total, params)
        res[dev.type] = (total.item(),
                         {k: out[k].detach().float().cpu()
                          for k in ("pred_logits", "pred_kpts2d",
                                    "pred_depth")},
                         [g.cpu() for g in grads])
        launched = ({k: v - fwd[k]
                     for k, v in ms_deform_attn.launches_by_dtype.items()},
                    {k: v - bwd[k] for k, v in
                     ms_deform_attn.backward_launches_by_dtype.items()})
        want = {"f32": n_layers if dev.type == "cuda" else 0, "bf16": 0}
        assert launched == (want, want), launched
    (loss_c, out_c, g_c), (loss_g, out_g, g_g) = res["cpu"], res["cuda"]
    for k, want in out_c.items():
        scale = max(1.0, want.abs().max().item()) * 2.0 ** -7
        units = (out_g[k] - want).abs().max().item() / scale
        assert units <= BF16_BAR, (k, units)
    assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= 1e-2 * abs(loss_c)
    gap = (sum((a - b).pow(2).sum() for a, b in zip(g_g, g_c))
           / sum(b.pow(2).sum() for b in g_c)).sqrt().item()
    assert gap <= GRAD_GAP, gap


# ------------------------------------------------------- the assignment
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (a) tied integer costs with zeroed padding columns, M from 1 to N, (b)
# continuous costs, (c) M = N and M = 1: the fixtures chip_smoke.py holds
# the kernel to on the card
lsa_fixtures = _chip_smoke().lsa_fixtures


def test_lsa_rows_kernel_matches_plain(cuda):
    """The kernel against the plain version on every slot of every
    fixture, the cost read as the matcher passes it (a transposed view),
    one launch a call."""
    for name, c in lsa_fixtures():
        cost = torch.from_numpy(c)
        before = lsa_rows.launches
        got = lsa_rows(cost.to(cuda).transpose(1, 2))
        assert lsa_rows.launches == before + 1
        want = lsa_rows_torch(cost.transpose(1, 2))
        torch.cuda.synchronize()
        assert got.dtype == torch.int64 and got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), name


def test_match_layers_one_launch_on_card(cuda):
    """``match_layers`` solves every decoder layer's problems at
    canonical_t4_f2's widths in one launch, and its indices, which stay on
    the card, are the plain version's on the same costs."""
    from snipper_tpu_torch.losses.criterion import matcher_weight_dict
    from snipper_tpu_torch.matching.matcher import cost_matrix, match_layers

    cfg = Config.canonical_t4_f2()
    w = matcher_weight_dict(cfg)
    rng = np.random.default_rng(7)
    B, n, T, K, M = (2, cfg.num_queries, cfg.num_frames, cfg.num_kpts,
                     cfg.max_persons)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    layers = [(put(rng.standard_normal((B, n, T, 2))),
               put(rng.uniform(0, 1, (B, n, T, K, 3))),
               put(rng.uniform(0, 1, (B, n, T, K, 1))))
              for _ in range(cfg.dec_layers)]
    kpts = rng.uniform(0, 1, (B, M, T, K, 3))
    kpts[..., 2] = kpts[..., 2] > 0.3
    valid = np.zeros((B, M), bool)
    valid[0, :3] = valid[1, :1] = True
    targets = {"kpts2d": put(kpts), "depth": put(rng.uniform(
        0, 1, (B, M, T, K, 2))), "valid": torch.from_numpy(valid).to(cuda)}
    before = lsa_rows.launches
    got = match_layers(layers, targets, cfg.max_depth, w)
    assert lsa_rows.launches == before + 1
    assert len(got) == cfg.dec_layers
    assert all(s.device.type == "cuda" for s in got)
    cost = torch.stack([
        cost_matrix(*lay, targets["kpts2d"], targets["depth"],
                    cfg.max_depth, w) * targets["valid"][:, None].float()
        for lay in layers]).cpu()
    for g, c in zip(got, cost):
        assert torch.equal(g.cpu(), lsa_rows_torch(c.transpose(1, 2)))


# ------------------------------------------- the device warp, serving, eval
def test_device_warp_cuda_matches_cpu(cuda):
    """The warp on the card against the CPU within 1e-5, with TF32 matrix
    products allowed during the call: the warp gathers and blends in f32
    and has no matrix product for TF32 to touch."""
    from snipper_tpu_torch.data.device_preprocess import (
        invert_axis_aligned, warp_affine_device)
    from snipper_tpu_torch.data.transforms import gen_trans_from_patch

    rng = np.random.default_rng(0)
    cases = [  # (frames, forward affine, out shape, flip)
        (rng.integers(0, 256, (4, 720, 1280, 3), np.uint8),
         gen_trans_from_patch(640.0, 360.0, 960.0, 720.0, 800, 600, 0.0),
         (600, 800), False),
        (rng.integers(0, 256, (20, 20, 3), np.uint8),
         gen_trans_from_patch(10.0, 10.0, 60.0, 60.0, 24, 24, 0.0),
         (24, 24), True),
    ]
    for imgs, trans, shape, flip in cases:
        inv = invert_axis_aligned(trans)
        x = torch.from_numpy(imgs).pin_memory().to(cuda, non_blocking=True)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = warp_affine_device(x, inv, shape, do_flip=flip)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        want = warp_affine_device(torch.from_numpy(imgs), inv, shape,
                                  do_flip=flip)
        assert got.is_cuda and got.dtype == torch.float32
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def _tiny_checkpoint(path):
    """A trainer checkpoint of the tiny model with sampling projections
    that move the sampling points."""
    cfg = Config.tiny()
    model = build_model(cfg, device="cpu", seed=1)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    torch.save({"params": model.state_dict(), "step": 0}, path)
    return cfg


def test_cli_infer_device_preprocess_cuda_matches_cpu(cuda, tmp_path,
                                                      monkeypatch):
    """``cli.infer --device_preprocess`` on the card: the uint8 frames
    reach the warp from pinned memory, and the tracks equal the same run
    on the CPU."""
    import pickle

    from PIL import Image

    from snipper_tpu_torch.cli import infer as infer_cli

    cfg = _tiny_checkpoint(str(tmp_path / "ckpt.pt"))
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (72, 100, 3), np.uint8)).save(
            frames / f"{i:06d}.jpg")
    seen = []
    real = infer_cli.preprocess_snippet_device

    def spy(raw, *a, **kw):
        seen.append((torch.is_tensor(raw) and raw.is_pinned(),
                     str(kw.get("device", a[-1] if a else None))))
        return real(raw, *a, **kw)

    monkeypatch.setattr(infer_cli, "preprocess_snippet_device", spy)
    tracks = {}
    for dev in ("cuda", "cpu"):
        before = ms_deform_attn.launches
        out = tmp_path / dev
        stats = infer_cli.main([
            "--preset", "tiny", "--data_dir", str(frames), "--seq_gap", "1",
            "--resume", str(tmp_path / "ckpt.pt"), "--device_preprocess",
            "--output_dir", str(out), "--device", dev])
        assert stats["snippets"] == 4
        launches = ms_deform_attn.launches - before
        assert launches == (4 * (cfg.enc_layers + cfg.dec_layers)
                            if dev == "cuda" else 0)
        with open(out / "tracks.pkl", "rb") as f:
            tracks[dev] = pickle.load(f)
    assert seen[:4] == [(True, "cuda")] * 4
    assert [p for p, _ in seen[4:]] == [False] * 4
    got, want = tracks["cuda"], tracks["cpu"]
    assert got["max_pid"] == want["max_pid"] > 0
    assert set(got["frames"]) == set(want["frames"])
    for k, (pids, data) in want["frames"].items():
        assert list(got["frames"][k][0]) == list(pids)
        np.testing.assert_allclose(got["frames"][k][1], data, rtol=1e-3,
                                   atol=5e-3)


def test_cli_eval_cuda_matches_cpu(cuda, tmp_path):
    """``cli.eval`` at the tiny preset on the card (kernel) against
    ``--device cpu`` (plain): every number of ``eval_stats.json`` within
    1e-4 relative."""
    import json

    from snipper_tpu_torch.cli import eval as eval_cli

    cfg = _tiny_checkpoint(str(tmp_path / "ckpt.pt"))
    stats = {}
    for dev in ("cuda", "cpu"):
        before = ms_deform_attn.launches
        res = eval_cli.main([
            "--preset", "tiny", "--synthetic", "--synthetic_samples", "4",
            "--num_workers", "0", "--resume", str(tmp_path / "ckpt.pt"),
            "--output_dir", str(tmp_path / dev), "--device", dev])
        assert res["batches"] == 4
        assert ms_deform_attn.launches - before == (
            4 * (cfg.enc_layers + cfg.dec_layers) if dev == "cuda" else 0)
        with open(tmp_path / dev / "eval_stats.json") as f:
            stats[dev] = json.load(f)
    assert set(stats["cuda"]) == set(stats["cpu"])
    for k, v in stats["cpu"].items():
        np.testing.assert_allclose(stats["cuda"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


# ------------------------------- training from raw frames with the warp on
def _raw_batch(rng, B=2, T=2, sizes=((90, 120), (130, 260)), out=(64, 96)):
    """A stacked raw batch of frames of two sizes (zero-padded to
    128-multiples) with rotated, flipped and colour-jittered warps and
    padded targets, as ``stack_batch`` collates a device-preprocess
    loader's samples."""
    from snipper_tpu_torch.data.snippet import stack_batch
    from snipper_tpu_torch.data.transforms import (fold_flip_inverse,
                                                   gen_trans_from_patch)

    samples = []
    for b in range(B):
        h, w = sizes[b % len(sizes)]
        trans = gen_trans_from_patch(w / 2, h / 2, 1.3 * w, 1.3 * h,
                                     out[1], out[0], [17.0, -25.0][b % 2])
        kpts = np.zeros((4, T + 1, 15, 3), np.float32)
        kpts[:2, ..., :2] = rng.uniform(0.2, 0.8, (2, T + 1, 15, 2))
        kpts[:2, ..., 2] = 1.0
        depth = np.zeros((4, T + 1, 15, 2), np.float32)
        samples.append({
            "raw_images": rng.integers(0, 256, (T, h, w, 3), np.uint8),
            "warp_inv": np.repeat(fold_flip_inverse(trans, b % 2 == 1, w)
                                  [None], T, 0),
            "color_scale": np.array([1.2, 0.8, 1.1], np.float32),
            "targets": {"kpts2d": kpts, "depth": depth,
                        "valid": np.array([True, True, False, False])}})
    return stack_batch(samples)


def test_train_warp_cuda_matches_cpu(cuda):
    """``warp_train_batch_device`` on the card against the CPU within 1e-5
    (f32 gathers and blends of the same terms), frames copied from pinned
    memory."""
    from snipper_tpu_torch.data.device_preprocess import \
        warp_train_batch_device

    for shape, B in (((64, 96), 2), ((600, 800), 2)):
        batch = _raw_batch(np.random.default_rng(B + shape[0]), B=B,
                           out=shape, sizes=((720, 1280), (1080, 1920))
                           if shape[0] == 600 else ((90, 120), (130, 260)))
        args = [torch.from_numpy(batch[k]) for k in
                ("raw_images", "warp_inv", "color_scale")]
        got = warp_train_batch_device(
            *[a.pin_memory().to(cuda, non_blocking=True) for a in args],
            shape)
        want = warp_train_batch_device(*args, shape)
        assert got.is_cuda and got.dtype == torch.float32
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def test_prefetch_side_stream_delivers_the_batches(cuda):
    """``pin_batch`` + ``device_prefetch`` with a side stream: every batch
    arrives on the card in order and equal to its host copy, while a
    kernel on the current stream runs between the copies."""
    from snipper_tpu_torch.data.loader import device_prefetch, pin_batch
    from snipper_tpu_torch.train.step import batch_to_device

    rng = np.random.default_rng(3)
    host = [_raw_batch(rng) for _ in range(4)]
    pinned = [pin_batch(b) for b in host]
    assert all(pinned[0][k].is_pinned() for k in
               ("raw_images", "warp_inv", "color_scale"))
    side = torch.cuda.Stream(cuda)
    busy = torch.randn(2048, 2048, device=cuda)
    got = []
    for b in device_prefetch(iter(pinned),
                             lambda x: batch_to_device(x, cuda), side):
        busy = busy @ busy / 2048.0  # work on the current stream
        got.append({k: v.cpu() for k, v in b.items() if k != "targets"})
    assert len(got) == len(host)
    for g, h in zip(got, host):
        for k in ("raw_images", "warp_inv", "color_scale"):
            np.testing.assert_array_equal(g[k].numpy(), h[k])


def test_bf16_train_step_from_raw_batch(cuda):
    """A bf16 mixed-precision train step at the tiny preset from a raw
    batch on the card: the warp runs in f32 inside the step, losses and
    gradient norm are finite, and 12 launches are counted per kernel
    (enc + dec layers), forward and backward."""
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import batch_to_device, train_step

    cfg = Config.tiny().replace(batch_size=2)
    batch = batch_to_device(_raw_batch(np.random.default_rng(5)), cuda)
    model = build_model(cfg, device=cuda, seed=2)
    state = create_train_state(cfg, model, steps_per_epoch=4)
    fwd, bwd = ms_deform_attn.launches, ms_deform_attn.backward_launches
    metrics = train_step(state, SetCriterion(cfg), batch,
                         torch.Generator().manual_seed(0),
                         mixed_precision=True)
    vals = {k: v.item() for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in vals.values()), vals
    assert vals["grad_norm"] > 0
    n = cfg.enc_layers + cfg.dec_layers
    assert ms_deform_attn.launches - fwd == n
    assert ms_deform_attn.backward_launches - bwd == n


# ------------------------------------------- windowed sampling and the probe
GRID_SHAPES = [(24, 32), (12, 16), (6, 8)]
GRID_SIZES = [h * w for h, w in GRID_SHAPES]


def _grid_inputs(device, value_dtype, teleport=False, B=2, NH=2, D=8, P=2):
    """Encoder-style grid queries with offsets of up to 3.9 pixels;
    ``teleport`` moves one tap outside its window."""
    rng = np.random.default_rng(11)
    S = sum(GRID_SIZES)
    L = len(GRID_SHAPES)
    refs = []
    for (h, w) in GRID_SHAPES:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    off = rng.uniform(-3.9, 3.9, (B, S, NH, L, P, 2))
    norm = np.array([(w, h) for h, w in GRID_SHAPES], np.float64)
    loc = (np.concatenate(refs, 0)[None, :, None, None, None, :]
           + off / norm[None, None, None, :, None, :]).astype(np.float32)
    if teleport:
        loc[1, 5, 1, 0, 0] = [0.97, 0.97]
    v = rng.standard_normal((B, S, NH, D)).astype(np.float32)
    w = rng.uniform(0, 1, (B, S, NH, L, P)).astype(np.float32)
    return (torch.from_numpy(v).to(device, value_dtype),
            torch.from_numpy(loc).to(device), torch.from_numpy(w).to(device))


@pytest.mark.parametrize("teleport", [False, True], ids=["inside", "teleport"])
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_win2d_sample_matches_plain(cuda, value_dtype, teleport):
    """The windowed2d kernel path (one launch per query segment) against
    the plain windowed2d: f32 within 1e-5; a bf16 value within one bf16
    unit of the largest output (both round one f32 sum once); the same
    overflow count, > 0 for the teleported tap."""
    value, loc, attn = _grid_inputs(cuda, value_dtype, teleport)
    kw = dict(block_h=6, block_w=8, margin_px=5)
    before = win2d.win2d_sample.launches
    got, got_ov = win2d.ms_deform_attn_windowed2d_kernel(
        value, GRID_SHAPES, loc, attn, GRID_SIZES, **kw)
    assert win2d.win2d_sample.launches == before + len(GRID_SHAPES)
    want, want_ov = ms_deform_attn_windowed2d(value, GRID_SHAPES, loc, attn,
                                              GRID_SIZES, **kw)
    torch.cuda.synchronize()
    assert got.dtype == value_dtype
    assert float(got_ov) == float(want_ov)
    assert (float(got_ov) > 0) == teleport
    scale = max(1.0, want.float().abs().max().item())
    tol = 1e-5 if value_dtype == torch.float32 else 2.0 ** -7 * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


def _misaligned(t):
    """A contiguous copy of ``t`` one element off 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _sample_plan_qb(D, value_dtype):
    """Queries per block of ``win2d_sample``'s plan (``make_plan``): 256
    threads over groups of min(vectors per row, 32) threads, 16-byte
    vectors where D allows."""
    vec = 16 // torch.empty((), dtype=value_dtype).element_size()
    nv = D // vec if D % vec == 0 else D
    return 256 // min(nv, 32)


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "d6", "d12", "misaligned",
                                  "many_taps", "wide", "straddle"])
def test_win2d_sample_kernel_sizes_match_plain(cuda, case, value_dtype):
    """``win2d_sample`` at sizes beyond the probe's, against the plain
    windowed2d, with the tolerances of
    :func:`test_win2d_sample_matches_plain` and equal overflow counts:

    - ``ragged``: 5x7 query blocks, so every segment has a ragged edge of
      padded queries;
    - ``d6``, ``d12``: D = 6 and 12, no multiple of 16 bytes in bf16;
    - ``misaligned``: the value one element off 16-byte alignment;
    - ``many_taps``: P = 6, 72 taps per query at D = 48;
    - ``wide``: D = 600 at 6x8 blocks, C*D*4 = 115 KB, more than the 100 KB
      of shared memory that the first version's [C, D] sum could take;
    - ``straddle``: 5x9 blocks at D = 48, so C = 45 is no multiple of the
      plan's queries per block and blocks of groups straddle two (nb, bh),
      among them two query blocks with their own anchors.
    """
    D, P, block = {"ragged": (8, 2, (5, 7)), "d6": (6, 2, (6, 8)),
                   "d12": (12, 2, (6, 8)), "misaligned": (16, 2, (6, 8)),
                   "many_taps": (48, 6, (6, 8)), "wide": (600, 2, (6, 8)),
                   "straddle": (48, 2, (5, 9))}[case]
    value, loc, attn = _grid_inputs(cuda, value_dtype, D=D, P=P)
    if case == "misaligned":
        value = _misaligned(value)
    C = block[0] * block[1]
    if case == "wide":
        assert C * D * 4 > 100 * 1024
    if case == "straddle":
        qb = _sample_plan_qb(D, value_dtype)
        BH = value.shape[0] * value.shape[2]
        assert C % qb != 0
        # a block of groups holds the last query of (nb, bh) = (0, BH - 1)
        # and the first of (1, 0)
        assert (BH * C - 1) // qb == BH * C // qb
    kw = dict(block_h=block[0], block_w=block[1], margin_px=5)
    before = win2d.win2d_sample.launches
    got, got_ov = win2d.ms_deform_attn_windowed2d_kernel(
        value, GRID_SHAPES, loc, attn, GRID_SIZES, **kw)
    assert win2d.win2d_sample.launches == before + len(GRID_SHAPES)
    want, want_ov = ms_deform_attn_windowed2d(value, GRID_SHAPES, loc, attn,
                                              GRID_SIZES, **kw)
    torch.cuda.synchronize()
    assert got.dtype == value_dtype
    assert float(got_ov) == float(want_ov)
    scale = max(1.0, want.float().abs().max().item())
    tol = 1e-5 if value_dtype == torch.float32 else 2.0 ** -7 * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


def _contract_case(case, device):
    """(wins, ids, wgts) for one path of ``win2d_contract``:

    - ``d48``: D = 48, the float4 path, 16 taps;
    - ``d6``: D = 6, the scalar path;
    - ``d4``: D = 4, one float4 a query: 256 queries a block, so 16 taps
      take two chunks of the block's tap table;
    - ``misaligned``: windows one element off 16-byte alignment, the scalar
      path at D = 16;
    - ``wide``: C = 300 queries of D = 96, C*D*4 = 115 KB, above the 100 KB
      that a shared-memory accumulator of the block could hold, with
      K = 40 taps;
    - ``outside``: ids outside [0, Wd) with nonzero weight, K = 5, and a
      C (37) that leaves the last block ragged.
    """
    rng = np.random.default_rng(17)
    NB, BH = 2, 3
    C, D, K, widths = {"d48": (64, 48, 16, (100, 64)),
                       "d6": (50, 6, 16, (90, 64)),
                       "d4": (70, 4, 16, (128, 40)),
                       "misaligned": (40, 16, 16, (96, 33)),
                       "wide": (300, 96, 40, (200,)),
                       "outside": (37, 8, 5, (100, 300))}[case]
    wins, ids, wgts = [], [], []
    for Wd in widths:
        w = torch.from_numpy(rng.standard_normal((NB, BH, Wd, D))
                             .astype(np.float32)).to(device)
        i = rng.integers(0, Wd, (NB, BH, C, K))
        if case == "outside":
            i[..., 0] = -1 - rng.integers(0, 40, (NB, BH, C))
            i[..., 1] = Wd + rng.integers(0, 40, (NB, BH, C))
            i[..., 2] = 10 ** 6
        g = rng.uniform(0, 1, (NB, BH, C, K))
        wins.append(_misaligned(w) if case == "misaligned" else w)
        ids.append(torch.from_numpy(i.astype(np.int32)).to(device))
        wgts.append(torch.from_numpy(g.astype(np.float32)).to(device))
    return wins, ids, wgts


@pytest.mark.parametrize("case", ["d48", "d6", "d4", "misaligned", "wide",
                                  "outside"])
def test_win2d_contract_paths_match_plain(cuda, case):
    """``win2d_contract`` on every path it chooses from the sizes, against
    its plain version within 1e-5 of the output's largest value."""
    wins, ids, wgts = _contract_case(case, cuda)
    before = win2d.win2d_contract.launches
    got = win2d.win2d_contract(wins, ids, wgts)
    assert win2d.win2d_contract.launches == before + 1
    want = win2d.win2d_contract_torch(wins, ids, wgts)
    torch.cuda.synchronize()
    tol = 1e-5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def _hier_case(case, device):
    """(winsT, idsT, wgtsT) for one path of ``hier_gather``:

    - ``k5``: 5 taps per query and level (K < 16), D = 16;
    - ``one_tile``: every tap of every query in one 32-column tile (16
      shuffle rounds there, none elsewhere), D = 48;
    - ``outside``: ids outside [0, Wd) with nonzero weight: negative, past
      Wd inside the last (partial) tile, far beyond; D = 20 (a masked
      last channel chunk);
    - ``padded``: C = 70 queries padded to Cp = 128 with weight 0, D = 48.
    """
    rng = np.random.default_rng(13)
    NB, BH, C, Cp = 2, 3, 64, 64
    D, K, widths = {"k5": (16, 5, (100, 64)), "one_tile": (48, 16, (256,)),
                    "outside": (20, 16, (100, 300)),
                    "padded": (48, 16, (96, 200))}[case]
    if case == "padded":
        C, Cp = 70, 128
    winsT, idsT, wgtsT = [], [], []
    for Wd in widths:
        w = rng.standard_normal((NB, BH, D, Wd))
        i = rng.integers(0, Wd, (NB, BH, K, Cp))
        g = rng.uniform(0, 1, (NB, BH, K, Cp))
        if case == "one_tile":
            i = rng.integers(64, 96, (NB, BH, K, Cp))
        if case == "outside":
            i[..., 0, :] = -1 - rng.integers(0, 40, (NB, BH, Cp))
            i[..., 1, :] = Wd + rng.integers(0, 32 - Wd % 32, (NB, BH, Cp))
            i[..., 2, :] = 10 ** 6
        g[..., C:] = 0.0
        i[..., C:] = 0
        winsT.append(torch.from_numpy(w.astype(np.float32)).to(device))
        idsT.append(torch.from_numpy(i.astype(np.int32)).to(device))
        wgtsT.append(torch.from_numpy(g.astype(np.float32)).to(device))
    return winsT, idsT, wgtsT


@pytest.mark.parametrize("case", ["k5", "one_tile", "outside", "padded"])
def test_hier_gather_paths_match_plain(cuda, case):
    """``hier_gather`` against its plain version within 1e-5 of the
    output's largest value; padded queries come out 0."""
    winsT, idsT, wgtsT = _hier_case(case, cuda)
    before = win2d.hier_gather.launches
    got = win2d.hier_gather(winsT, idsT, wgtsT)
    assert win2d.hier_gather.launches == before + 1
    want = win2d.hier_gather_torch(winsT, idsT, wgtsT)
    torch.cuda.synchronize()
    tol = 1e-5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    if case == "padded":
        assert got[..., 70:].abs().max().item() == 0.0


def test_win2d_contract_and_hier_gather_match_plain(cuda):
    """Both contractions against the gather-and-sum of their definition,
    within 1e-5 of the output's largest value."""
    wins, winsT, ids, idsT, wgts, wgtsT, _ = _fixture(
        3, 70, (256, 128, 384), BH=4, D=16, device=cuda)
    before = (win2d.win2d_contract.launches, win2d.hier_gather.launches)
    got5 = win2d.win2d_contract(wins, ids, wgts)
    got4 = win2d.hier_gather(winsT, idsT, wgtsT)
    assert (win2d.win2d_contract.launches,
            win2d.hier_gather.launches) == (before[0] + 1, before[1] + 1)
    want5 = win2d.win2d_contract_torch(wins, ids, wgts)
    want4 = win2d.hier_gather_torch(winsT, idsT, wgtsT)
    torch.cuda.synchronize()
    for got, want in ((got5, want5), (got4, want4)):
        tol = 1e-5 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol
    torch.testing.assert_close(got4.transpose(2, 3)[:, :, :70], got5,
                               rtol=0, atol=1e-5 * want5.abs().max().item())


def _chain_case(case, device):
    """(x, idx, n) for one case of the lane chains:

    - ``odd_n``: 3 x 40 rows, n = 9 (the select chain's odd tail);
    - ``even_n``: the same rows, n = 10;
    - ``n0``: n = 0, the rows copied;
    - ``ragged_rows``: 129 rows, no multiple of the 8 warps of a block;
    - ``one_register``: every id in [32, 64), all in one register of its
      lane (four requests a lane for one register);
    - ``one_lane``: every id names lane 7 of some register;
    - ``resident``: 20,000 rows, more than the resident grid's warps, so
      each warp walks several rows and prefetches the next.
    """
    rng = np.random.default_rng(12)
    rows, n, lo, hi = {"odd_n": ((3, 40), 9, 0, 128),
                       "even_n": ((3, 40), 10, 0, 128),
                       "n0": ((3, 40), 0, 0, 128),
                       "ragged_rows": ((3, 43), 9, 0, 128),
                       "one_register": ((2, 40), 9, 32, 64),
                       "one_lane": ((2, 40), 9, 0, 4),
                       "resident": ((20000,), 12, 0, 128)}[case]
    x = rng.standard_normal((*rows, 128)).astype(np.float32)
    idx = rng.integers(lo, hi, (*rows, 128))
    if case == "one_lane":
        idx = 7 + 32 * idx
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(idx.astype(np.int32)).to(device), n)


@pytest.mark.parametrize("case", ["odd_n", "even_n", "n0", "ragged_rows",
                                  "one_register", "one_lane", "resident"])
@pytest.mark.parametrize("name", ["chain_gather", "chain_select"])
def test_lane_chain_matches_plain_bitwise(cuda, name, case):
    x, idx, n = _chain_case(case, cuda)
    fn = getattr(lane_chain, name)
    before = fn.launches
    got = fn(x, idx, n)
    assert fn.launches == before + 1
    want = getattr(lane_chain, f"{name}_torch")(x, idx, n)
    assert torch.equal(got, want)


def test_new_kernel_wrappers_reject_bad_inputs(cuda):
    """CPU tensors, types and sizes the kernels do not take raise
    (``hier_gather`` with K > 16 or Cp not a multiple of 32;
    ``win2d_contract`` and ``win2d_sample`` have no size limit of shared
    memory, test_win2d_contract_paths_match_plain[wide] and
    test_win2d_sample_kernel_sizes_match_plain[wide]); nothing falls back
    to a plain version."""
    value, loc, attn = _grid_inputs(cuda, torch.float32)
    blocks, wins = windowed2d_plan(GRID_SHAPES, 6, 8, 5)
    taps = win2d.segment_taps(GRID_SHAPES, loc[:, :GRID_SIZES[0]],
                              attn[:, :GRID_SIZES[0]], GRID_SHAPES[0],
                              blocks[0], wins[0])
    with pytest.raises(TypeError):
        win2d.win2d_sample(value.half(), GRID_SHAPES, taps)
    with pytest.raises(ValueError, match="CUDA"):
        win2d.win2d_sample_cuda(value.cpu(), GRID_SHAPES, taps)
    fx = _fixture(2, 5, (128,), BH=2, D=8, device=cuda)
    with pytest.raises(TypeError):
        win2d.win2d_contract([fx[0][0].bfloat16()], fx[2], fx[4])
    with pytest.raises(ValueError, match="CUDA"):
        win2d.win2d_contract_cuda([fx[0][0].cpu()], fx[2], fx[4])
    with pytest.raises(TypeError):
        win2d.hier_gather(fx[1], [fx[3][0].long()], fx[5])
    many = _fixture(1, 32, (64,), BH=1, D=8, n_taps=17, device=cuda)
    with pytest.raises(ValueError, match="K <= 16"):
        win2d.hier_gather_cuda(many[1], many[3], many[5])
    odd = [t[..., :40].contiguous() for t in fx[3] + fx[5]]
    with pytest.raises(ValueError, match="multiple of 32"):
        win2d.hier_gather_cuda(fx[1], odd[:1], odd[1:])
    x = torch.zeros(2, 128, device=cuda)
    idx = torch.zeros(2, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        lane_chain.chain_gather(x, idx.long(), 2)
    with pytest.raises(ValueError, match="CUDA"):
        lane_chain.chain_select_cuda(x.cpu(), idx.cpu(), 2)
