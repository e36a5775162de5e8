"""Gradients of the port's deformable sampling against the JAX package's.

The plain VJP (``ms_deform_attn_torch_vjp``, autograd through
``F.grid_sample``) is held against ``jax.vjp`` of ``ms_deform_attn_core``
and against ``jax.grad`` through ``ms_deform_attn_pallas_grad`` (the
Pallas forward in interpret mode on the CPU with its custom VJP, as
tests/test_pallas_deform.py runs it); ``torch.autograd.gradcheck`` checks
the plain version in float64; the port's ``temporal_deform_sample``
gradients are held against JAX ``impl="xla"``. Inputs are numpy from a
seed, f32. The CUDA backward kernel is tested in
tests/test_torch_port_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snipper_tpu.ops.deform_attn import ms_deform_attn_core
from snipper_tpu.ops.deform_attn import temporal_adjacency as jax_adjacency
from snipper_tpu.ops.deform_attn import \
    temporal_deform_sample as jax_temporal_deform_sample
from snipper_tpu.ops.pallas_deform import ms_deform_attn_pallas_grad
from snipper_tpu_torch.ops.deform_attn import (temporal_adjacency,
                                               temporal_deform_sample)
from snipper_tpu_torch.ops.msda import (backward_plan, ms_deform_attn,
                                        ms_deform_attn_torch,
                                        ms_deform_attn_torch_vjp,
                                        msda_backward)

SHAPES = [(6, 9), (3, 5), (2, 2)]
S = sum(h * w for h, w in SHAPES)
TOL = 1e-5


def _inputs(seed, B=2, NH=4, D=8, LQ=23, P=3):
    """Locations in [-0.1, 1.1], so corners fall off the map; a random
    cotangent."""
    rng = np.random.default_rng(seed)
    L = len(SHAPES)
    v = rng.standard_normal((B, S, NH, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, LQ, NH, L, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, LQ, NH, L, P)).astype(np.float32)
    g = rng.standard_normal((B, LQ, NH * D)).astype(np.float32)
    return v, loc, w, g


def _torch_vjp(v, loc, w, g):
    return [t.numpy() for t in ms_deform_attn_torch_vjp(
        torch.from_numpy(v), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(w), torch.from_numpy(g))]


def test_plain_vjp_matches_jax_core_vjp():
    v, loc, w, g = _inputs(0)
    got = _torch_vjp(v, loc, w, g)
    _, vjp = jax.vjp(lambda a, b, c: ms_deform_attn_core(a, SHAPES, b, c),
                     jnp.asarray(v), jnp.asarray(loc), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(("d_value", "d_loc", "d_attn"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_plain_vjp_matches_pallas_grad_interpret():
    """``jax.grad`` through the trainable Pallas driver (interpret mode):
    the gradient of <out, g>."""
    v, loc, w, g = _inputs(1)
    got = _torch_vjp(v, loc, w, g)
    gj = jnp.asarray(g)
    want = jax.grad(
        lambda a, b, c: jnp.sum(ms_deform_attn_pallas_grad(a, SHAPES, b, c)
                                * gj), argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(loc), jnp.asarray(w))
    for name, a, b in zip(("d_value", "d_loc", "d_attn"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_plain_version_gradcheck_float64():
    """Float64 finite differences of the plain version (locations away
    from pixel edges, where the bilinear derivative is one-sided)."""
    rng = np.random.default_rng(2)
    shapes = [(4, 5), (2, 3)]
    s = sum(h * w for h, w in shapes)
    v = torch.from_numpy(rng.standard_normal((1, s, 2, 3)))
    loc = torch.from_numpy(rng.uniform(-0.05, 1.05, (1, 4, 2, 2, 2, 2)))
    w = torch.from_numpy(rng.uniform(0, 1, (1, 4, 2, 2, 2)))
    for t in (v, loc, w):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: ms_deform_attn_torch(a, shapes, b, c), (v, loc, w),
        eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,Tf", [(4, 0), (4, 2), (1, 0)])
def test_temporal_deform_sample_grads_match_jax(T, Tf):
    """Gradients through the softmax, the /count division and the
    neighbour-frame value sum, for value, locations and logits."""
    rng = np.random.default_rng(T * 10 + Tf + 100)
    B, NH, D, LQ, P, L = 2, 4, 8, 11, 2, len(SHAPES)
    T1 = T + Tf
    value = rng.standard_normal((B, T, S, NH, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, T1, LQ, NH, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, T1, LQ, NH, L, P)).astype(np.float32)
    g = rng.standard_normal((B, T1, LQ, NH * D)).astype(np.float32)

    ts = [torch.from_numpy(x).requires_grad_(True)
          for x in (value, loc, logits)]
    out, _ = temporal_deform_sample(ts[0], SHAPES, ts[1], ts[2],
                                    temporal_adjacency(T, T1))
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))

    gj = jnp.asarray(g)
    adj = jax_adjacency(T, T1)
    want = jax.grad(lambda a, b, c: jnp.sum(jax_temporal_deform_sample(
        a, SHAPES, b, c, adj, impl="xla")[0] * gj), argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(logits))
    for name, a, b in zip(("d_value", "d_loc", "d_logits"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_cpu_autograd_takes_the_plain_version():
    """On the CPU, ``ms_deform_attn`` is the plain version for autograd
    too: no kernel launch either way."""
    v, loc, w, g = _inputs(3)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (v, loc, w)]
    before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
    out = ms_deform_attn(*ts[:1], SHAPES, *ts[1:])
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    assert (ms_deform_attn.launches,
            ms_deform_attn.backward_launches) == before
    for a, b in zip(got, _torch_vjp(v, loc, w, g)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_backward_wrapper_refuses_cpu_tensors():
    """The backward kernel's wrapper launches on CUDA tensors or raises;
    it never computes on the CPU itself."""
    v, loc, w, g = _inputs(4)
    with pytest.raises(ValueError, match="CUDA"):
        msda_backward(torch.from_numpy(v), SHAPES, torch.from_numpy(loc),
                      torch.from_numpy(w), torch.from_numpy(g))


CANONICAL = [(75, 100), (38, 50), (19, 25)]   # 600x800 at strides 8/16/32


@pytest.mark.parametrize("case", [
    "train_encoder", "train_decoder", "largest_level", "wide_level",
    "many_taps"])
def test_backward_plan_from_shapes(case):
    """The backward's scratch follows from the shapes alone: the index
    (four int32 per tap, N*H*L*Lq*P) and the cells' segments (a pair per
    cell, N*H*sum (h+1)(w+1)), on either side of the level size at which
    the index kernel's counters leave shared memory (12288 cells); 2^31
    taps or more in one (frame, head) refused."""
    N, shapes, H, Lq, P = {
        # canonical_t4_f2 at batch 8: B*T and B*(T+Tf) frames
        "train_encoder": (32, CANONICAL, 8, 9875, 4),
        "train_decoder": (48, CANONICAL, 8, 60, 4),
        "largest_level": (1, [(95, 127), (3, 5)], 2, 7, 2),
        "wide_level": (1, [(95, 128), (3, 5)], 2, 7, 2),
        "many_taps": (1, [(6, 9)], 1, 2 ** 31, 1),
    }[case]
    S, L = sum(h * w for h, w in shapes), len(shapes)
    cells = sum((h + 1) * (w + 1) for h, w in shapes)
    if case == "many_taps":
        with pytest.raises(ValueError, match="2\\^31 taps"):
            backward_plan(N, S, H, Lq, P, shapes)
        return
    n_index, n_segs = backward_plan(N, S, H, Lq, P, shapes)
    assert (n_index, n_segs) == (N * H * L * Lq * P * 4, N * H * cells * 2)
    if case == "train_encoder":   # 485 MB of index, 21 MB of segments
        assert (n_index * 4, n_segs * 4) == (485_376_000, 20_858_880)


def test_backward_plan_limit_matches_kernel_source():
    """The kernel's ``MSDA_INDEX_SHARED_CELLS`` counters fit in the 48 KB
    a block gets without opting in, and the largest level of every preset
    (stride 8 of its input) is within it, so no preset's backward counts
    in global memory."""
    import re

    from snipper_tpu_torch.config import PRESETS, Config
    from snipper_tpu_torch.ops import _build

    src = (_build.CSRC / "msda_backward.cu").read_text()
    got = re.search(r"#define MSDA_INDEX_SHARED_CELLS (\d+)", src)
    assert got
    limit = int(got.group(1))
    assert 0 < limit * 4 <= 48 * 1024
    for name in PRESETS:
        h, w = getattr(Config, name)().input_shape
        assert (-(-h // 8) + 1) * (-(-w // 8) + 1) <= limit, name
