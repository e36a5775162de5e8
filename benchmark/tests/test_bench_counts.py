"""The counts of work against hand counts at tiny shapes."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import flops, msda, peaks
from benchmark.reference import model as ref_model
from benchmark.reference.precision import Precision
from conftest import TINY


def _cfg(**kw):
    import dataclasses

    from snipper_tpu_torch.config import Config

    return dict(dataclasses.asdict(Config()), **TINY, **kw)


def test_sampling_call_by_hand():
    # N=1, Lq=2, H=1, D=4, P=1, levels 2x2 and 1x1: 2 taps a level
    shapes = [(2, 2), (1, 1)]
    nbytes, ops = msda.call_work(1, 2, 1, 4, 1, shapes, 4)
    rows = min(4, 4 * 2) + min(1, 4 * 2)          # 4 + 1 rows reached
    taps = 1 * 2 * 1 * 2 * 1
    assert nbytes == rows * 4 * 4 + taps * 8 + taps * 4 + 2 * 4 * 4
    assert ops == taps * (10 * 4 + 20)
    b_bytes, b_ops = msda.call_work(1, 2, 1, 4, 1, shapes, 2, backward=True)
    assert b_bytes == (rows * 4 * 2 + taps * 12 + 2 * 4 * 2
                       + 5 * 4 * 4 + taps * 12)
    assert b_ops == taps * (16 * 4 + 30)
    assert msda.forward_ops((1, 5, 1, 4), (1, 2, 1, 2, 1, 2)) == \
        taps * (8 * 4 + 8)


def test_step_bound_sums_the_calls():
    c = _cfg(num_future_frames=1)
    shapes = ref_model.shapes_of(c)
    S = sum(h * w for h, w in shapes)
    H, D = c["nheads"], c["hidden_dim"] // c["nheads"]
    want = 0.0
    for N, Lq, n in ((2 * 2, S, c["enc_layers"]), (2 * 3, 8, c["dec_layers"])):
        b, o = msda.call_work(N, Lq, H, D, 4, shapes, 4)
        want += n * max(b / peaks.HBM_BYTES_PER_S,
                        o / peaks.FLOP_PER_S["float32"])
    got = msda.step_bound_s(c, 2, 4, False, peaks.HBM_BYTES_PER_S,
                            peaks.FLOP_PER_S["float32"])
    assert got == pytest.approx(want)


def test_attention_count_by_hand():
    C, H, N = 96, 4, 10
    P = {"a.in_proj_weight": torch.empty(3 * C, C, device="meta"),
         "a.in_proj_bias": torch.empty(3 * C, device="meta"),
         "a.out_proj.weight": torch.empty(C, C, device="meta"),
         "a.out_proj.bias": torch.empty(C, device="meta")}
    x = torch.empty(1, N, C, device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_model.self_attention(P, "a", x, x, H, Precision())
    # q, k, v and out projections; logits and mixing
    assert fc.get_total_flops() == 2 * N * C * C * 4 + 2 * 2 * N * N * C


def test_model_count_scales_with_the_batch():
    c = _cfg()
    one, two = flops.model_flops(c, 1), flops.model_flops(c, 2)
    assert two == pytest.approx(2 * one)
    step = flops.model_flops(dict(c, num_future_frames=1), 2, backward=True)
    fwd = flops.model_flops(dict(c, num_future_frames=1), 2)
    assert 2 * fwd < step < 3.2 * fwd
    # the stem alone: 2 x 64 x 3 x 49 multiply-adds per output pixel
    stem = 2 * 64 * 3 * 49 * (c["input_height"] // 2) * \
        (c["input_width"] // 2) * c["num_frames"]
    assert one > stem and math.isfinite(one)
