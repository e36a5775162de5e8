"""The host spans of the port's serving loop, eval loop, training step and
forward, read from a real ``torch.profiler`` trace of tiny CPU runs taken
by ``utils/profiling.py::trace``: each span by its name, its nesting, the
order of the forward's four stages, and the sums that ``serve_snippets``
reports beside them (``wait_ms``, ``forward_ms``).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from snipper_tpu_torch.cli import infer as cli_infer
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.infer.pipeline import associate_snippets
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.utils import profiling

CPU = torch.device("cpu")
STAGES = ("model.backbone", "model.encoder", "model.decoder", "model.heads")
SERVE = ("serve.wait", "serve.upload", "serve.readback", "serve.decode")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = Config.tiny()
    return cfg, build_model(cfg, device="cpu")


def _frames(root, n=7, w=160, h=120):
    d = root / "frames"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            d / f"{i:06d}.jpg")
    return str(d)


def _spans(log_dir):
    """The trace's host spans: ``(name, start, end, tid)``, times in ms."""
    path, = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"] / 1e3, (e["ts"] + e["dur"]) / 1e3, e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parents):
    return any(p[3] == child[3] and p[1] <= child[1] and child[2] <= p[2]
               for p in parents)


def _total(spans, name):
    return sum(b - a for _, a, b, _ in _named(spans, name))


def _assert_stages(spans, parent, calls):
    """The forward's four stages, once per call, each inside ``parent``,
    in order and apart within each call."""
    parents = _named(spans, parent)
    assert len(parents) == calls
    for p in parents:
        inner = sorted((s for s in spans if s[0] in STAGES
                        and _inside(s, [p])), key=lambda s: s[1])
        assert [s[0] for s in inner] == list(STAGES)
        assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


@pytest.mark.parametrize("device_preprocess", [False, True],
                         ids=["hostwarp", "devwarp"])
def test_serving_spans(tmp_path, tiny, device_preprocess):
    """serve_snippets + associate_snippets: every serving span, once a
    group, in the loop's order; the forward's four stages between
    ``serve.upload`` and ``serve.readback``; ``serve.wait`` is ``wait_ms``
    and upload + the stages + readback is ``forward_ms``, within 1 ms a
    group."""
    cfg, model = tiny
    data = _frames(tmp_path)
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        out = cli_infer.serve_snippets(model, cfg, data, 2, CPU,
                                       device_preprocess=device_preprocess)
        associate_snippets(out["results"], *out["index"], cfg.num_frames,
                           2, cfg.max_depth)
    spans = _spans(log_dir)
    groups = len(out["forward_ms"])
    assert groups == 3
    for name in SERVE:
        assert len(_named(spans, name)) == groups, name
    assert len(_named(spans, "serve.associate")) == 1
    warps = _named(spans, "serve.warp")
    if device_preprocess:
        assert len(warps) == groups
        assert all(_inside(s, _named(spans, "serve.upload")) for s in warps)
    else:
        assert not warps
    loop = sorted((s for s in spans if s[0] in SERVE + STAGES),
                  key=lambda s: s[1])
    assert [s[0] for s in loop] == \
        ["serve.wait", "serve.upload", *STAGES, "serve.readback",
         "serve.decode"] * groups
    assert all(a[2] <= b[1] for a, b in zip(loop, loop[1:]))
    assert abs(_total(spans, "serve.wait") - sum(out["wait_ms"])) \
        <= 1.0 * groups
    forward = sum(_total(spans, n) for n in
                  ("serve.upload", *STAGES, "serve.readback"))
    assert abs(forward - sum(out["forward_ms"])) <= 1.0 * groups


def test_eval_spans(tmp_path, tiny):
    """evaluate over two batches: the eval spans once a batch, the
    forward's stages and the criterion inside ``eval.step``, the matching
    inside the criterion."""
    from snipper_tpu_torch.data.loader import DataLoader
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.train.engine import evaluate

    cfg, model = tiny
    loader = DataLoader(SyntheticDataset(cfg, n_samples=4, seed=0), 2,
                        shuffle=False)
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        stats = evaluate(model, SetCriterion(cfg), loader, cfg, CPU)
    assert stats["_batches"] == 2
    spans = _spans(log_dir)
    for name in ("eval.upload", "eval.step", "eval.readback",
                 "eval.postprocess", "eval.metrics"):
        assert len(_named(spans, name)) == 2, name
    _assert_stages(spans, "eval.step", 2)
    for name, parent in (("criterion", "eval.step"),
                         ("match_layers", "criterion")):
        inner = _named(spans, name)
        assert len(inner) == 2
        assert all(_inside(s, _named(spans, parent)) for s in inner), name


def test_train_step_spans(tmp_path, tiny):
    """One traced step of train_one_epoch: the wait, the step with its
    backward and update inside, the readback; the forward's stages and
    the matching inside the step."""
    from snipper_tpu_torch.data.loader import DataLoader
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.train.engine import train_one_epoch
    from snipper_tpu_torch.train.state import create_train_state

    cfg, _ = tiny
    model = build_model(cfg, device="cpu")
    state = create_train_state(cfg, model, steps_per_epoch=2)
    loader = DataLoader(SyntheticDataset(cfg, n_samples=2, seed=0), 2,
                        shuffle=False)
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        _, history = train_one_epoch(
            state, SetCriterion(cfg), loader, 0,
            torch.Generator().manual_seed(0), CPU, mixed_precision=False,
            max_steps=1)
    assert len(history) == 1
    spans = _spans(log_dir)
    for name in ("train.wait", "train.step", "train.readback"):
        assert _named(spans, name), name
    steps = _named(spans, "train.step")
    for name in ("train.backward", "train.update", "criterion",
                 "match_layers"):
        inner = _named(spans, name)
        assert len(inner) == 1 and _inside(inner[0], steps), name
    _assert_stages(spans, "train.step", 1)


def test_no_loop_span_open_inside_the_model_call(tmp_path, tiny,
                                                  monkeypatch):
    """The serving loop's ``model`` may switch profilers (the benchmark's
    traced sub-windows start and stop in its forward callable); a span
    open across such a switch has torch write its end into the first
    profiler's freed events. So no span of the loop is open inside the
    call."""
    import contextlib

    cfg, model = tiny
    open_spans, seen = [], []

    @contextlib.contextmanager
    def tracked(name):
        open_spans.append(name)
        try:
            yield
        finally:
            open_spans.remove(name)

    def forward(imgs):
        seen.append(list(open_spans))
        return model(imgs)

    monkeypatch.setattr(cli_infer, "record_function", tracked)
    out = cli_infer.serve_snippets(forward, cfg, _frames(tmp_path), 2, CPU)
    assert len(seen) == len(out["forward_ms"]) == 3
    assert seen == [[]] * 3
