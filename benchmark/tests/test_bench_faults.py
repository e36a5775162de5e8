"""The run with the timed path broken underneath: ``correct`` comes out
false, once for each fault a cell can have (one card: no exchange between
cards to leave out)."""

from unittest import mock

import numpy as np
import pytest

from conftest import run_tiny


def _altered_decode(real):
    def f(*a, **k):
        prob, score, kpts, depth = real(*a, **k)
        return prob, score, kpts + np.float32(8.0), depth
    return f


def test_serve_answer_altered():
    from snipper_tpu_torch.cli import infer

    with mock.patch.object(infer, "decode_predictions",
                           _altered_decode(infer.decode_predictions)):
        r = run_tiny("serve_t4_hostwarp")
    assert not r["correct"]
    assert r["checks"]["decoded_gap"]["value"] > \
        r["checks"]["decoded_gap"]["limit"]


def test_eval_answer_altered():
    from snipper_tpu_torch.train import engine

    real = engine.postprocess

    def altered(*a, **k):
        res = real(*a, **k)
        for r in res:
            r["pred_depth"] = r["pred_depth"] * np.float32(1.1)
        return res

    with mock.patch.object(engine, "postprocess", altered):
        r = run_tiny("eval_t4f2_b2")
    assert not r["correct"]


TRAIN_CELLS = ["train_t4f2_b2", "train_t4f2_b8"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_state_unchanged(cell):
    from snipper_tpu_torch.train import step

    def no_update(state, grads, norm):
        state.optimizer.zero_grad(set_to_none=True)
        state.updates += 1

    with mock.patch.object(step, "apply_update", no_update):
        r = run_tiny(cell)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] > \
        r["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_half_batch(cell):
    from snipper_tpu_torch.train import engine

    real = engine.train_step

    def half(state, crit, batch, gen, **k):
        n = batch["targets"]["valid"].shape[0] // 2
        cut = {key: v[:n] for key, v in batch.items() if key != "targets"}
        cut["targets"] = {key: v[:n] for key, v in batch["targets"].items()}
        return real(state, crit, cut, gen, **k)

    with mock.patch.object(engine, "train_step", half):
        r = run_tiny(cell)
    assert not r["correct"]
