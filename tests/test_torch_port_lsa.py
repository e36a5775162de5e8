"""The port's on-device assignment against the JAX package's: the plain
``lsa_rows_torch`` against JAX's Jonker-Volgenant ``hungarian`` and the
port's ``match_layers`` against JAX's ``match(solver="jax")``, on every
target slot, padding included, with ties.

The tied fixtures are integer costs in {0..3} with the padding columns
zeroed, as ``match`` zeroes them: every dual stays an exact f32 integer,
so only the order of the algorithm's steps decides which of the equal
optima comes out. scipy's solver finds the same optimal cost and breaks
the ties another way. JAX runs on the CPU, jitted; inputs are numpy from a
seed. The kernel is held against the plain version on the same fixtures
in tests/test_torch_port_cuda.py.

    python -m pytest tests/test_torch_port_lsa.py -q
"""

import numpy as np
import pytest
import scipy.optimize
import torch

import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.losses.criterion import SetCriterion as JaxCriterion
from snipper_tpu.matching import matcher as jmatcher
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.matching import matcher as tmatcher
from snipper_tpu_torch.ops.lsa import lsa_rows, lsa_rows_torch
from test_torch_port_cuda import lsa_fixtures
from test_torch_port_train import MAXD, _problem, _to_jax, _to_torch

FIXTURES = dict(lsa_fixtures())
TIED = [k for k in FIXTURES if k.startswith("tied")]


def _jax_hungarian(c):
    return np.asarray(jmatcher.hungarian(jnp.asarray(c)))


def _port(c):
    """The plain version on the matcher's layout: rows = targets."""
    return lsa_rows_torch(torch.from_numpy(c).transpose(1, 2)).numpy()


@pytest.mark.parametrize("n", [8, 20, 60])
def test_lsa_rows_torch_matches_jax_on_tied_costs(n):
    """(a) Integer costs with zeroed padding columns, M from 1 to N: equal
    on all M slots of every problem."""
    names = [k for k in TIED if k.startswith(f"tied_n{n}_")]
    assert names
    for name in names:
        np.testing.assert_array_equal(_port(FIXTURES[name]),
                                      _jax_hungarian(FIXTURES[name]),
                                      err_msg=name)


def test_tied_fixtures_hold_enough_problems():
    assert sum(len(FIXTURES[k]) for k in TIED) >= 200


def test_scipy_route_breaks_ties_otherwise():
    """The ``solver="scipy"`` cross-check reaches the same optimal cost as
    JAX's solver on every tied problem, but hands some valid slot another
    query in many of them: the reason the default solver is JAX's."""
    differ = 0
    for name in TIED:
        c = FIXTURES[name]
        want = _jax_hungarian(c)
        got = tmatcher.hungarian_scipy(c)
        for p in range(len(c)):
            nv = int(np.count_nonzero(c[p].any(0))) or 1
            rows = np.arange(c.shape[2])
            np.testing.assert_allclose(c[p][got[p], rows].sum(),
                                       c[p][want[p], rows].sum())
            differ += bool((got[p, :nv] != want[p, :nv]).any())
    assert differ > 0


@pytest.mark.parametrize("name", ["continuous_n8_m4", "continuous_n60_m32"])
def test_lsa_rows_torch_matches_jax_on_continuous_costs(name):
    """(b) Continuous costs."""
    np.testing.assert_array_equal(_port(FIXTURES[name]),
                                  _jax_hungarian(FIXTURES[name]))


@pytest.mark.parametrize("name", ["edge_n7_m7", "edge_n60_m60", "edge_n9_m1",
                                  "edge_n60_m1"])
def test_lsa_rows_torch_matches_jax_at_edge_shapes(name):
    """(c) M = N and M = 1."""
    np.testing.assert_array_equal(_port(FIXTURES[name]),
                                  _jax_hungarian(FIXTURES[name]))


def test_hungarian_counts_steps_and_takes_the_matcher_layout():
    """``hungarian`` solves ``[B, n, M]`` (rows = targets) as JAX's does;
    the plain version counts each problem's Dijkstra steps, at most
    M (M + 1) / 2."""
    c = FIXTURES["tied_n20_m15"]
    got = tmatcher.hungarian(torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), _jax_hungarian(c))
    assert got.dtype == torch.int64
    _, steps = lsa_rows_torch(torch.from_numpy(c).transpose(1, 2),
                              return_steps=True)
    assert ((steps >= 15) & (steps <= 15 * 16 // 2)).all(), steps


def test_lsa_rows_rejects_bad_inputs():
    c = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="rows <= columns"):
        lsa_rows(c)
    with pytest.raises(ValueError, match=r"\[P, M, N\]"):
        lsa_rows(c[0])
    with pytest.raises(TypeError, match="float32"):
        lsa_rows(c.transpose(1, 2).double())
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        lsa_rows(c.transpose(1, 2).to("meta"))


def _layers(outputs):
    layers = [tuple(_to_torch([outputs["pred_logits"],
                               outputs["pred_kpts2d"],
                               outputs["pred_depth"]]))]
    for i in range(len(outputs.get("aux_logits", []))):
        layers.append(tuple(_to_torch([outputs["aux_logits"][i],
                                       outputs["aux_kpts2d"][i],
                                       outputs["aux_depth"][i]])))
    return layers


def _unseen_target_problem():
    """A valid target whose joints are all unseen in the snippet (no
    visible joint, no depth) beside real ones, and predictions whose
    visibility is the same for every query: that target's cost column is
    one constant, so every query ties for it."""
    outputs, targets = _problem(2)
    targets["valid"][1, :2] = True
    targets["kpts2d"][1, 1] = 0.0
    targets["depth"][1, 1] = 0.0
    for k in ("pred_kpts2d", "aux_kpts2d"):
        outputs[k][..., 2] = 0.5
    return outputs, targets


@pytest.mark.parametrize("fixture", ["seed1", "seed4", "unseen_target"])
def test_match_layers_matches_jax_match_on_every_slot(fixture, monkeypatch):
    """``match_layers(solver="jax")`` against JAX's ``match(...,
    solver="jax")`` layer by layer, on every slot; scipy's solver raises
    if it is reached, so no host solve runs on this path."""
    outputs, targets = (_unseen_target_problem() if fixture == "unseen_target"
                        else _problem(int(fixture[4:])))
    w = JaxCriterion(JaxConfig()).match_weights

    def no_host_solve(*args, **kwargs):
        raise AssertionError("scipy's linear_sum_assignment was called")

    monkeypatch.setattr(scipy.optimize, "linear_sum_assignment",
                        no_host_solve)
    layers = _layers(outputs)
    got = tmatcher.match_layers(layers, _to_torch(targets), MAXD, w)
    assert len(got) == len(layers) == 3
    for (lg, kp, dp), src in zip(layers, got):
        want, _ = jmatcher.match(
            {"pred_logits": jnp.asarray(lg.numpy()),
             "pred_kpts2d": jnp.asarray(kp.numpy()),
             "pred_depth": jnp.asarray(dp.numpy())},
            _to_jax(targets), MAXD, w, solver="jax")
        np.testing.assert_array_equal(src.numpy(), np.asarray(want))
    if fixture == "unseen_target":
        cost = tmatcher.cost_matrix(*layers[0], *_to_torch(
            [targets["kpts2d"], targets["depth"]]), MAXD, w)
        assert torch.unique(cost[1, :, 1]).numel() == 1


def test_unknown_solver_raises_jax_message():
    outputs, targets = _problem(1)
    w = JaxCriterion(JaxConfig()).match_weights
    with pytest.raises(ValueError) as want:
        jmatcher.match({k: jnp.asarray(outputs[k]) for k in
                        ("pred_logits", "pred_kpts2d", "pred_depth")},
                       _to_jax(targets), MAXD, w, solver="typo")
    with pytest.raises(ValueError) as got:
        tmatcher.match_layers(_layers(outputs), _to_torch(targets), MAXD, w,
                              solver="typo")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown solver 'typo'"):
        SetCriterion(Config())(_to_torch(outputs), _to_torch(targets),
                               solver="typo")
