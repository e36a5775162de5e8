"""The plain reference against the program at a tiny size on the CPU, f32:
the forward, the criterion and its matching, a training update, the
decoding, the association and both warps."""

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.reference import criterion as ref_crit
from benchmark.reference import model as ref_model
from benchmark.reference import postprocess as ref_post
from benchmark.reference import train as ref_train
from benchmark.weights import make_weights
from conftest import TINY

CFG = dict(TINY, num_future_frames=1)


def _full_cfg():
    from snipper_tpu_torch.config import Config
    import dataclasses

    return dict(dataclasses.asdict(Config()), **CFG)


def _program(c, P):
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.models.snipper import Snipper

    cfg = Config(**c)
    with torch.device("meta"):
        m = Snipper(cfg)
    m.to_empty(device="cpu")
    m.load_state_dict(P)
    return cfg, m


def _batch(c, n=2, seed=3):
    s = generate.samples(c, n, seed, torch.device("cpu"))
    from benchmark.drivers.train import _device_batch

    return s, _device_batch(s, list(range(n)), torch.device("cpu"))


@pytest.fixture(scope="module")
def setup():
    c = _full_cfg()
    P = make_weights(c, 2 ** 31 + 3, torch.device("cpu"), 1.0)
    return c, P


def test_forward_matches(setup):
    c, P = setup
    _, m = _program(c, P)
    _, b = _batch(c)
    with torch.no_grad():
        want = ref_model.forward(P, b["images"], c)
        got = m.eval()(b["images"])
    for k in ("pred_logits", "pred_kpts2d", "pred_depth", "aux_logits"):
        assert torch.allclose(got[k], want[k], atol=1e-5, rtol=1e-5), k
    for g, w in zip(got["heatmaps"], want["heatmaps"]):
        assert torch.allclose(g, w, atol=1e-5, rtol=1e-5)


def test_criterion_and_matching_match(setup):
    from snipper_tpu_torch.losses.criterion import SetCriterion

    c, P = setup
    cfg, m = _program(c, P)
    _, b = _batch(c, seed=4)
    with torch.no_grad():
        out = m.eval()(b["images"])
        total, losses, src = SetCriterion(cfg)(out, b["targets"])
        r_total, r_losses, r_src = ref_crit.criterion(out, b["targets"],
                                                         c)
    assert set(losses) == set(r_losses)
    for k, v in losses.items():
        assert float(v) == pytest.approx(float(r_losses[k]), rel=1e-5,
                                         abs=1e-7), k
    assert float(total) == pytest.approx(float(r_total), rel=1e-6)
    valid = b["targets"]["valid"].numpy()
    assert np.array_equal(src.numpy()[valid], r_src[0][valid])


def test_training_update_matches(setup):
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import train_step

    c, P = setup
    c = dict(c, dropout=0.0)
    cfg, m = _program(c, P)
    _, b1 = _batch(c, seed=5)
    _, b2 = _batch(c, seed=6)
    state = create_train_state(cfg, m)
    crit = SetCriterion(cfg)
    gen = torch.Generator().manual_seed(0)
    got = [float(train_step(state, crit, b, gen,
                            mixed_precision=False)["loss_total"])
           for b in (b1, b2)]
    ref = ref_train.train_steps(P, [b1, b2], c)
    assert got == pytest.approx(ref["loss"], rel=1e-5)
    params = dict(m.named_parameters())
    for k, v in ref["params"].items():
        moved = torch.linalg.vector_norm(params[k].detach() - P[k])
        want = torch.linalg.vector_norm(v - ref["start"][k])
        assert float(moved) == pytest.approx(float(want), rel=2e-2,
                                             abs=1e-9), k


def test_decode_and_association_match():
    from snipper_tpu_torch.infer.pipeline import associate_snippets
    from snipper_tpu_torch.infer.postprocess import decode_predictions

    rng = np.random.default_rng(0)
    T, n, K, gap = 4, 8, 15, 4
    results = []
    for s in range(5):
        lg = rng.normal(0, 2, (n, T, 2)).astype(np.float32)
        kp = rng.uniform(0, 1, (n, T, K, 3)).astype(np.float32) * 0.2
        kp[..., 0, :2] = rng.uniform(0.2, 0.8, (n, T, 2))
        d = rng.uniform(0, 1, (n, T, K, 1)).astype(np.float32)
        got = decode_predictions(lg, kp, d, 15.0, (800, 600))
        want = ref_post.decode(lg, kp, d, 15.0, (800, 600))
        for g, w in zip(got, want):
            assert np.allclose(g, w, rtol=1e-6, atol=1e-4)
        prob, score, k2, dep = got
        results.append({"human_score": prob, "pred_kpt_scores": score,
                        "pred_kpts": k2, "pred_depth": dep,
                        "inv_trans": np.array([[1.6, 0, 0], [0, 1.6, -60]],
                                              np.float32),
                        "img_size": np.array([1280, 720], np.float32),
                        "filenames": [f"{12 * s + gap * t:06d}.jpg"
                                      for t in range(T)]})
    starts = [12 * s for s in range(5)]
    files = [f"{i:06d}.jpg" for i in range(61)]
    got = associate_snippets(results, starts, files, T, gap, 15.0)
    want = ref_post.associate(results, starts, T, gap, 15.0)
    assert got[1] > 0
    assert ref_post.tracks_mismatch(got, want) == 0


def test_warps_match():
    from snipper_tpu_torch.data.device_preprocess import \
        preprocess_snippet_device
    from snipper_tpu_torch.data.transforms import (gen_trans_from_patch,
                                                   generate_patch_image)

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (72, 128, 3), dtype=np.uint8)
    h, w = 60, 80
    want = ref_post.warp(img, h, w)
    scale = max(128 / w, 72 / h)
    trans = gen_trans_from_patch(64.0, 36.0, w * scale, h * scale, w, h, 0.0)
    host = generate_patch_image(img, False, trans, (h, w))
    dev = preprocess_snippet_device(img[None], trans.astype(np.float32),
                                    (h, w)).numpy()[0]
    assert np.abs(host - want).max() < 1e-4
    assert np.abs(dev - want).max() < 2e-3


@pytest.fixture(scope="module")
def whole_batch_steps(setup):
    """Three updates at batch 4 over the whole batch at once; the second
    batch holds a sample of no person, so that its block's own target
    count is not the batch's."""
    c, P = setup
    c = dict(c, dropout=0.0)
    s = generate.samples(c, 12, 7, torch.device("cpu"))
    t = s[5]["targets"]
    t["valid"][:] = False
    t["kpts2d"][:] = 0.0
    t["depth"][:] = 0.0
    from benchmark.drivers.train import _device_batch

    batches = [_device_batch(s, list(range(i, i + 4)), torch.device("cpu"))
               for i in (0, 4, 8)]
    return c, P, batches, ref_train.train_steps(P, batches, c)


@pytest.mark.parametrize("rows", [1, 2])
def test_training_in_blocks_of_rows_is_the_whole_batch(whole_batch_steps,
                                                       rows):
    """The reference over blocks of rows against the whole batch: the step
    losses, every leaf's first clipped gradient and the norm of every
    leaf's change after 3 steps (the norms the check compares), within
    1e-5 relative: f32 sums taken in another order."""
    c, P, batches, want = whole_batch_steps
    got = ref_train.train_steps(P, batches, c, rows=rows)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    for k, g in want["grad"].items():
        gap = torch.linalg.vector_norm(got["grad"][k] - g)
        assert float(gap) <= 1e-5 * float(torch.linalg.vector_norm(g)), k
    for k, p in want["params"].items():
        moved = torch.linalg.vector_norm(got["params"][k] - P[k])
        assert float(moved) == pytest.approx(float(torch.linalg.vector_norm(
            p - P[k])), rel=1e-5), k
