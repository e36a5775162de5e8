"""The port's deformable sampling against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages in f32.
The Pallas kernel runs in interpret mode on the CPU, as
tests/test_pallas_deform.py runs it. The CUDA kernel itself is tested in
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snipper_tpu.ops.deform_attn import ms_deform_attn_core
from snipper_tpu.ops.deform_attn import temporal_adjacency as jax_adjacency
from snipper_tpu.ops.deform_attn import \
    temporal_deform_sample as jax_temporal_deform_sample
from snipper_tpu.ops.pallas_deform import ms_deform_attn_pallas
from snipper_tpu_torch.ops.deform_attn import (temporal_adjacency,
                                               temporal_deform_sample)
from snipper_tpu_torch.ops.msda import (ms_deform_attn, ms_deform_attn_torch,
                                        msda_forward)

SHAPES = [(6, 9), (3, 5), (2, 2)]
S = sum(h * w for h, w in SHAPES)


def _msda_inputs(seed, B=2, NH=4, D=8, LQ=37, P=3, lo=-0.1, hi=1.1):
    """Locations in [lo, hi]: with the default [-0.1, 1.1], corners fall
    off the map."""
    rng = np.random.default_rng(seed)
    L = len(SHAPES)
    v = rng.standard_normal((B, S, NH, D)).astype(np.float32)
    loc = rng.uniform(lo, hi, (B, LQ, NH, L, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, LQ, NH, L, P)).astype(np.float32)
    return v, loc, w


def test_msda_torch_matches_jax_core_and_pallas():
    v, loc, w = _msda_inputs(0)
    got = ms_deform_attn_torch(torch.from_numpy(v), SHAPES,
                               torch.from_numpy(loc),
                               torch.from_numpy(w)).numpy()
    core = np.asarray(ms_deform_attn_core(jnp.asarray(v), SHAPES,
                                          jnp.asarray(loc), jnp.asarray(w)))
    pallas = np.asarray(ms_deform_attn_pallas(
        jnp.asarray(v), SHAPES, jnp.asarray(loc), jnp.asarray(w),
        interpret=True))
    np.testing.assert_allclose(got, core, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_msda_torch_offmap_samples_are_zero():
    """Locations wholly outside the map (more than a pixel off) sample
    zeros: the zero-padding of grid_sample."""
    v, loc, w = _msda_inputs(1, lo=1.6, hi=2.0)
    got = ms_deform_attn_torch(torch.from_numpy(v), SHAPES,
                               torch.from_numpy(loc), torch.from_numpy(w))
    assert torch.count_nonzero(got) == 0


def test_temporal_adjacency_matches_jax():
    for n, t in ((4, 4), (4, 6), (1, 1), (2, 3)):
        np.testing.assert_array_equal(temporal_adjacency(n, t),
                                      jax_adjacency(n, t))


@pytest.mark.parametrize("T,Tf", [(4, 0), (4, 2), (1, 0)])
def test_temporal_deform_sample_matches_jax(T, Tf):
    """Softmax over L*P then / frame count, neighbour values summed, T1 = T
    (encoder) or T + Tf (decoder)."""
    rng = np.random.default_rng(T * 10 + Tf)
    B, NH, D, LQ, P, L = 2, 4, 8, 11, 2, len(SHAPES)
    T1 = T + Tf
    value = rng.standard_normal((B, T, S, NH, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, T1, LQ, NH, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, T1, LQ, NH, L, P)).astype(np.float32)
    adj = temporal_adjacency(T, T1)
    got, overflow = temporal_deform_sample(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(logits), adj)
    want, j_overflow = jax_temporal_deform_sample(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(logits),
        jax_adjacency(T, T1), impl="xla")
    assert overflow == 0 and float(j_overflow) == 0.0
    assert tuple(got.shape) == (B, T1, LQ, NH * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    v, loc, w = _msda_inputs(2)
    args = (torch.from_numpy(v), SHAPES, torch.from_numpy(loc),
            torch.from_numpy(w))
    before = ms_deform_attn.launches
    out = ms_deform_attn(*args)
    assert ms_deform_attn.launches == before
    torch.testing.assert_close(out, ms_deform_attn_torch(*args), rtol=0,
                               atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises; it never
    computes on the CPU itself."""
    v, loc, w = _msda_inputs(3)
    with pytest.raises(ValueError, match="CUDA"):
        msda_forward(torch.from_numpy(v), SHAPES, torch.from_numpy(loc),
                     torch.from_numpy(w))
