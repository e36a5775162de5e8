"""The port's windowed sampling against the JAX package's.

``pmerged``, ``windowed`` and ``windowed2d`` (plain PyTorch in the port,
XLA in the JAX package) and ``ms_deform_attn_windowed2d_kernel`` (on the
CPU, ``win2d_sample`` runs the kernel's plain version) against
``ms_deform_attn_pmerged``,
``ms_deform_attn_windowed``, ``ms_deform_attn_windowed2d`` and
``ms_deform_attn_windowed2d_pallas`` (Pallas in interpret mode, its
default off the TPU), on ``tests/test_pallas_deform.py``'s encoder-grid
fixture. Inputs are made with numpy from a seed.

Tolerances: f32 within 1e-5 (the bar of ``test_pallas_deform.py``); a bf16
value within 1e-2 of the largest output against JAX, which rounds its
one-hot weights to bf16 before the MXU where the port keeps them f32, and
within one bf16 unit of the largest output between the port's two
versions, which differ only in the order of their f32 sums. Overflow
counts are equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snipper_tpu.ops import deform_attn as jda
from snipper_tpu.ops.pallas_deform import ms_deform_attn_windowed2d_pallas
from snipper_tpu_torch.ops import deform_attn as tda
from snipper_tpu_torch.ops import win2d

SHAPES = [(24, 32), (12, 16), (6, 8)]
SIZES = [h * w for h, w in SHAPES]
BF16_UNIT = 2.0 ** -7   # spacing of bf16 relative to a value's magnitude


def _grid_inputs(teleport=False):
    """Encoder-style grid queries with offsets of up to 3.9 pixels
    (``test_pallas_deform.py:52-67``); ``teleport`` moves one tap to the
    far corner, outside its window."""
    rng = np.random.default_rng(0)
    value = rng.standard_normal((1, sum(SIZES), 2, 4)).astype(np.float32)
    refs = []
    for (h, w) in SHAPES:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    ref = np.concatenate(refs, 0)
    off = rng.uniform(-3.9, 3.9, (1, sum(SIZES), 2, 3, 2, 2))
    norm = np.array([(w, h) for h, w in SHAPES], np.float64)
    loc = (ref[None, :, None, None, None, :]
           + off / norm[None, None, None, :, None, :]).astype(np.float32)
    attn = rng.uniform(0, 1, (1, sum(SIZES), 2, 3, 2)).astype(np.float32)
    if teleport:
        loc[0, 5, 0, 0, 0] = [0.97, 0.97]
    return value, loc, attn


def _both(value, loc, attn, bf16):
    """The inputs as (jax, torch) arrays, the value in bf16 if asked."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    return ((jnp.asarray(value, jdt), jnp.asarray(loc), jnp.asarray(attn)),
            (torch.from_numpy(value).to(tdt), torch.from_numpy(loc),
             torch.from_numpy(attn)))


@functools.lru_cache(maxsize=None)
def _jax_windowed2d(block, margin, pallas):
    """The JAX function, jitted once per configuration (compiling costs
    seconds, running milliseconds)."""
    kw = dict(spatial_shapes=SHAPES, query_segments=SIZES, block_h=block[0],
              block_w=block[1], margin_px=margin)
    if pallas:
        return jax.jit(functools.partial(ms_deform_attn_windowed2d_pallas,
                                         interpret=True, **kw))
    return jax.jit(functools.partial(jda.ms_deform_attn_windowed2d, **kw))


def _run_jax(fn, j):
    out, ov = fn(j[0], sampling_locations=j[1], attention_weights=j[2])
    return np.asarray(out.astype(jnp.float32)), float(ov)


def _close(got, want, bf16, against_jax=True):
    scale = max(1.0, float(np.abs(want).max()))
    tol = (1e-2 if against_jax else BF16_UNIT) * scale if bf16 else 1e-5
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def test_plans_match_jax():
    for shapes in (SHAPES, [(75, 100), (38, 50), (19, 25)], [(9, 7)]):
        for bc, m in ((512, 5), (128, 1), (64, 0)):
            assert tda.windowed_sampling_plan(shapes, bc, m) \
                == jda.windowed_sampling_plan(shapes, bc, m)
        for bh, bw, m in ((8, 20, 5), (6, 8, 5), (5, 7, 0), (2, 2, 8)):
            assert tda.windowed2d_plan(shapes, bh, bw, m) \
                == jda.windowed2d_plan(shapes, bh, bw, m)


@pytest.mark.parametrize("window", [None, (384, 128, 0)])
def test_pmerged_matches_jax(window):
    """Point-merged sampling, exact or over 1D windows of query chunks of
    100 (the teleported tap overflows its window)."""
    j, t = _both(*_grid_inputs(teleport=True), bf16=False)
    kw = dict(spatial_shapes=SHAPES, query_chunk=100, window=window)
    want = jax.jit(functools.partial(jda.ms_deform_attn_pmerged, **kw))(
        j[0], sampling_locations=j[1], attention_weights=j[2])
    got = tda.ms_deform_attn_pmerged(t[0], SHAPES, t[1], t[2],
                                     query_chunk=100, window=window)
    if window is not None:
        (want, want_ov), (got, got_ov) = want, got
        assert float(got_ov) == float(want_ov) > 0
    _close(got.numpy(), np.asarray(want), bf16=False)


@pytest.mark.parametrize("bc,margin,bf16", [(128, 1, False), (64, 0, True)],
                         ids=["f32", "bf16"])
def test_windowed_matches_jax(bc, margin, bf16):
    j, t = _both(*_grid_inputs(teleport=True), bf16=bf16)
    kw = dict(spatial_shapes=SHAPES, query_segments=SIZES, base_chunk=bc,
              margin_px=margin)
    want, want_ov = _run_jax(
        jax.jit(functools.partial(jda.ms_deform_attn_windowed, **kw)), j)
    got, got_ov = tda.ms_deform_attn_windowed(t[0], SHAPES, t[1], t[2],
                                              SIZES, base_chunk=bc,
                                              margin_px=margin)
    assert float(got_ov) == want_ov > 0
    _close(got.float().numpy(), want, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("block", [(6, 8), (5, 7)])
def test_windowed2d_and_kernel_path_match_jax(block, bf16):
    """The plain windowed2d against the XLA function, the kernel path
    (on the CPU, the kernel's plain version) against the Pallas kernel,
    and the two against each other; no tap overflows at margin 5."""
    j, t = _both(*_grid_inputs(), bf16=bf16)
    xla, xla_ov = _run_jax(_jax_windowed2d(block, 5, False), j)
    pallas, pallas_ov = _run_jax(_jax_windowed2d(block, 5, True), j)
    kw = dict(block_h=block[0], block_w=block[1], margin_px=5)
    plain, plain_ov = tda.ms_deform_attn_windowed2d(t[0], SHAPES, t[1], t[2],
                                                    SIZES, **kw)
    before = win2d.win2d_sample.launches
    drv, drv_ov = win2d.ms_deform_attn_windowed2d_kernel(
        t[0], SHAPES, t[1], t[2], SIZES, **kw)
    assert win2d.win2d_sample.launches == before   # CPU: no kernel
    assert plain.dtype == drv.dtype == t[0].dtype
    assert float(plain_ov) == float(drv_ov) == xla_ov == pallas_ov == 0.0
    _close(plain.float().numpy(), xla, bf16)
    _close(drv.float().numpy(), pallas, bf16)
    _close(drv.float().numpy(), plain.float().numpy(), bf16,
           against_jax=False)


def test_windowed2d_teleported_tap_overflow_matches_jax():
    """A tap teleported out of its window is dropped and counted: the four
    functions count the same (> 0). The plan at margin 5 has windows and
    disabled windows (whole levels) side by side."""
    _, wins = tda.windowed2d_plan(SHAPES, 6, 8, 5)
    assert {w == (0, 0) for seg in wins for w in seg} == {True, False}
    j, t = _both(*_grid_inputs(teleport=True), bf16=False)
    xla, xla_ov = _run_jax(_jax_windowed2d((6, 8), 5, False), j)
    pallas, pallas_ov = _run_jax(_jax_windowed2d((6, 8), 5, True), j)
    kw = dict(block_h=6, block_w=8, margin_px=5)
    plain, plain_ov = tda.ms_deform_attn_windowed2d(t[0], SHAPES, t[1], t[2],
                                                    SIZES, **kw)
    drv, drv_ov = win2d.ms_deform_attn_windowed2d_kernel(
        t[0], SHAPES, t[1], t[2], SIZES, **kw)
    assert float(plain_ov) == float(drv_ov) == xla_ov == pallas_ov > 0
    _close(plain.numpy(), xla, False)
    _close(drv.numpy(), pallas, False)


def test_windowed2d_with_every_window_disabled_is_exact():
    """At margin 8 the plan disables every window on these shapes: both
    versions then sample whole levels, equal the exact sampling and count
    no overflow, even for the teleported tap."""
    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch

    _, wins = tda.windowed2d_plan(SHAPES, 6, 8, 8)
    assert all(w == (0, 0) for seg in wins for w in seg)
    _, t = _both(*_grid_inputs(teleport=True), bf16=False)
    exact = ms_deform_attn_torch(t[0], SHAPES, t[1], t[2]).numpy()
    for fn in (tda.ms_deform_attn_windowed2d,
               win2d.ms_deform_attn_windowed2d_kernel):
        out, ov = fn(t[0], SHAPES, t[1], t[2], SIZES, block_h=6, block_w=8,
                     margin_px=8)
        assert float(ov) == 0.0
        _close(out.numpy(), exact, False)


def test_segment_taps_anchor_blocks_like_jax():
    """The kernel path's anchors: per block the least live row and column over
    batch, heads and taps, clipped; padded queries (7 is no multiple of 5)
    weigh 0 and set no anchor."""
    value, loc, attn = _grid_inputs()
    blocks, wins = tda.windowed2d_plan(SHAPES, 5, 7, 5)
    taps = win2d.segment_taps(SHAPES, torch.from_numpy(loc[:, :SIZES[0]]),
                              torch.from_numpy(attn[:, :SIZES[0]]), SHAPES[0],
                              blocks[0], wins[0])
    (wy, wx), (h, w) = taps.windows[0], SHAPES[0]
    ys = taps.anchors[0, :, 0]
    xs = taps.anchors[0, :, 1]
    assert int(ys.min()) >= 0 and int(ys.max()) <= h - wy
    assert int(xs.min()) >= 0 and int(xs.max()) <= w - wx
    ids, wgts = taps.ids[0], taps.wgts[0]
    assert ids.dtype == torch.int32 and wgts.dtype == torch.float32
    assert int(ids.max()) <= wy * wx and float(taps.overflow) == 0.0
    # the last block column holds 32 - 4 * 7 = 4 real query columns
    C = blocks[0][0] * blocks[0][1]
    pad = torch.arange(C) % blocks[0][1] >= 4
    nbx = -(-w // blocks[0][1])
    assert float(wgts[nbx - 1::nbx][:, :, pad].abs().sum()) == 0.0


def test_win2d_kernels_refuse_cpu_tensors():
    """The launch functions take CUDA tensors or raise; they never compute
    on the CPU themselves."""
    value, loc, attn = (torch.from_numpy(a) for a in _grid_inputs())
    blocks, wins = tda.windowed2d_plan(SHAPES, 6, 8, 5)
    taps = win2d.segment_taps(SHAPES, loc[:, :SIZES[0]], attn[:, :SIZES[0]],
                              SHAPES[0], blocks[0], wins[0])
    with pytest.raises(ValueError, match="CUDA"):
        win2d.win2d_sample_cuda(value, SHAPES, taps)
    w = [torch.zeros(2, 2, 128, 4)]
    i = [torch.zeros(2, 2, 3, 4, dtype=torch.int32)]
    g = [torch.zeros(2, 2, 3, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        win2d.win2d_contract_cuda(w, i, g)
    with pytest.raises(ValueError, match="CUDA"):
        win2d.hier_gather_cuda([w[0].transpose(2, 3).contiguous()],
                               [torch.zeros(2, 2, 4, 32, dtype=torch.int32)],
                               [torch.zeros(2, 2, 4, 32)])
