"""The port's training entry point on the CPU at the tiny preset:
checkpoint and log per epoch (its keys against those of JAX's trainer),
``--resume auto``, the checkpoint feeding ``cli.infer --resume``, the
refused flags and the CUDA default."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from snipper_tpu_torch.cli import infer as infer_cli
from snipper_tpu_torch.cli import train as train_cli
from snipper_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                load_checkpoint)

ARGS = ["--preset", "tiny", "--synthetic", "--device", "cpu",
        "--steps_per_epoch", "2", "--synthetic_samples", "4",
        "--num_workers", "0"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    res = train_cli.main(ARGS + ["--epochs", "1", "--output_dir", str(out)])
    return out, res


def test_train_writes_checkpoint_and_eval_log(trained):
    out, res = trained
    ckpt = out / "ckpts" / "checkpoint0000.pt"
    assert res["checkpoint"] == str(ckpt) and ckpt.exists()
    state = load_checkpoint(str(ckpt))
    assert set(state) == {"params", "opt_state", "step"}
    assert state["step"] == 2
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["loss_total"]) for h in res["history"])
    lines = (out / "log.txt").read_text().splitlines()
    assert len(lines) == 1
    log = json.loads(lines[0])
    assert log["epoch"] == 0
    assert np.isfinite(log["train_loss_total"])
    assert np.isfinite(log["test_loss_total"])
    assert "test_loss_heatmap" in log
    assert res["eval"]["_batches"] == 4


def _jax_trainer_keys():
    """The metric keys of the train and eval steps that JAX's trainer builds
    by default (``snipper_tpu/cli/train.py:58-65``, ``:124-136``: windowed
    sampling, the exact model for the redo), read by tracing them on
    abstract inputs, without a compile."""
    import jax
    import jax.numpy as jnp

    from snipper_tpu.config import Config as JaxConfig
    from snipper_tpu.losses.criterion import SetCriterion
    from snipper_tpu.models.snipper import build_model
    from snipper_tpu.train.state import create_train_state
    from snipper_tpu.train.step import make_eval_step, make_train_step

    cfg = JaxConfig.tiny().replace(deform_impl="windowed_vjp")
    model = build_model(cfg)
    exact = build_model(cfg.replace(deform_impl="xla"))
    crit = SetCriterion(cfg)
    M, T1, K = cfg.max_persons, cfg.total_frames, cfg.num_kpts
    batch = {"images": jnp.zeros((1, cfg.num_frames, cfg.input_height,
                                  cfg.input_width, 3)),
             "targets": {"kpts2d": jnp.zeros((1, M, T1, K, 3)),
                         "depth": jnp.zeros((1, M, T1, K, 2)),
                         "valid": jnp.zeros((1, M), bool)}}

    def metrics():
        params = model.init(jax.random.PRNGKey(0), batch["images"])[
            "params"]
        state, tx = create_train_state(cfg, params, 1)
        _, train = make_train_step(model, crit, tx, exact_model=exact)(
            state, batch, jax.random.PRNGKey(1))
        _, test, _ = make_eval_step(model, crit, exact_model=exact)(
            params, batch)
        return train, test

    return jax.eval_shape(metrics)


def test_log_keys_match_jax_trainer(trained):
    """``log.txt`` holds the keys JAX's trainer writes: ``train_`` + its
    step's metrics and ``lr``, ``test_`` + its eval step's metrics and the
    3D/PCKh stats; among them the windowed sampling's redo rate, which the
    port, always exact, logs as 0. Without the windowed default (an exact
    ``--deform_impl``) JAX logs no redo rate, nor does the port."""
    from snipper_tpu.train.engine import PCKH_KEYS, POSE3D_KEYS

    from snipper_tpu_torch.config import Config

    out, _ = trained
    log = json.loads((out / "log.txt").read_text().splitlines()[0])
    train, test = _jax_trainer_keys()
    assert "sampling_exact_redo" in train and "sampling_exact_redo" in test
    got_train = {k[len("train_"):] for k in log if k.startswith("train_")}
    assert got_train == set(train) | {"lr"}
    got_test = {k[len("test_"):] for k in log if k.startswith("test_")}
    stats = {f"{p}{k}" for p in ("", "future_") for k in POSE3D_KEYS}
    assert set(test) <= got_test <= set(test) | stats | set(PCKH_KEYS)
    assert "3dpck" in got_test
    assert set(log) == {"epoch"} | {f"train_{k}" for k in got_train} | {
        f"test_{k}" for k in got_test}
    assert log["train_sampling_exact_redo"] == 0.0
    assert log["test_sampling_exact_redo"] == 0.0

    cfg = Config.tiny()
    for flag, impl, logged in ((None, "xla", True),
                               ("xla", "xla", False),
                               ("pmerged", "pmerged", False),
                               ("windowed2d", "windowed2d", True)):
        args = train_cli.build_parser().parse_args(
            [] if flag is None else ["--deform_impl", flag])
        got = train_cli.exact_redo_stats(args, cfg.replace(deform_impl=impl))
        assert got == ({"sampling_exact_redo": 0.0} if logged else {}), flag


def test_resume_auto_continues_at_next_epoch(trained, tmp_path):
    out, _ = trained
    work = tmp_path / "run"
    (work / "ckpts").mkdir(parents=True)
    src = out / "ckpts" / "checkpoint0000.pt"
    (work / "ckpts" / "checkpoint0000.pt").write_bytes(src.read_bytes())
    res = train_cli.main(ARGS + ["--epochs", "2", "--output_dir", str(work),
                                 "--resume", "auto"])
    assert res["start_epoch"] == 1
    assert len(res["history"]) == 2
    assert latest_checkpoint(str(work / "ckpts")).endswith(
        "checkpoint0001.pt")
    state = load_checkpoint(res["checkpoint"])
    assert state["step"] == 4
    assert state["opt_state"]["updates"] == 4
    assert json.loads((work / "log.txt").read_text().splitlines()[-1])[
        "epoch"] == 1


def test_resume_auto_without_checkpoint_starts_fresh(tmp_path):
    res = train_cli.main(ARGS + ["--epochs", "1", "--eval_every", "2",
                                 "--resume", "auto",
                                 "--output_dir", str(tmp_path)])
    assert res["start_epoch"] == 0 and res["eval"] is None


def test_infer_resume_loads_the_trainer_checkpoint(trained, tmp_path,
                                                   monkeypatch):
    """``cli.infer --resume`` reads the checkpoint's ``params``, as the
    JAX CLI does."""
    out, _ = trained
    ckpt = str(out / "ckpts" / "checkpoint0000.pt")
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), np.uint8)).save(
            frames / f"{i:06d}.jpg")
    built = []
    real_build = infer_cli.build_model

    def build(*a, **kw):
        built.append(real_build(*a, **kw))
        return built[-1]

    monkeypatch.setattr(infer_cli, "build_model", build)
    stats = infer_cli.main(["--preset", "tiny", "--data_dir", str(frames),
                            "--output_dir", str(tmp_path / "out"),
                            "--seq_gap", "1", "--resume", ckpt,
                            "--device", "cpu"])
    assert stats["snippets"] == 2
    assert os.path.exists(tmp_path / "out" / "tracks.pkl")
    want = load_checkpoint(ckpt)["params"]
    got = built[0].state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_deform_impl_is_accepted_and_ignored(tmp_path):
    """TPU-only knobs parse as in the JAX CLI; the port samples with its
    one exact gather whatever they say."""
    res = train_cli.main(ARGS + ["--epochs", "1", "--steps_per_epoch", "1",
                                 "--eval_every", "5", "--deform_impl",
                                 "pallas", "--output_dir", str(tmp_path)])
    assert len(res["history"]) == 1
    assert res["history"][0]["sampling_overflow"] == 0.0


@pytest.mark.parametrize("deform_dtype", ["auto", "float32"])
def test_deform_dtype_reaches_every_sampling(tmp_path, monkeypatch,
                                             deform_dtype):
    """``--deform_dtype`` is honoured, as in the JAX CLI: it reaches every
    ``TemporalDeformAttn`` of the model the trainer builds, and in the
    trainer's bf16 mixed-precision step every sampling call (one per
    encoder and decoder layer and step) takes a value of that dtype."""
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.models.transformer import TemporalDeformAttn
    from snipper_tpu_torch.ops import deform_attn

    built, seen = [], []
    real_build, real_sample = train_cli.build_model, deform_attn.ms_deform_attn

    def build(*a, **kw):
        built.append(real_build(*a, **kw))
        return built[-1]

    def spy(value, *args):
        seen.append(value.dtype)
        return real_sample(value, *args)

    monkeypatch.setattr(train_cli, "build_model", build)
    monkeypatch.setattr(deform_attn, "ms_deform_attn", spy)
    res = train_cli.main(ARGS + ["--epochs", "1", "--steps_per_epoch", "1",
                                 "--eval_every", "5", "--deform_dtype",
                                 deform_dtype, "--output_dir",
                                 str(tmp_path)])
    assert len(res["history"]) == 1
    assert np.isfinite(res["history"][0]["loss_total"])
    attns = [m for m in built[0].modules()
             if isinstance(m, TemporalDeformAttn)]
    cfg = Config.tiny()
    assert len(attns) == cfg.enc_layers + cfg.dec_layers
    assert all(m.sample_dtype == deform_dtype for m in attns)
    want = torch.float32 if deform_dtype == "float32" else torch.bfloat16
    assert seen == [want] * len(attns)


def test_train_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--preset", "tiny", "--synthetic", "--output_dir",
                        str(tmp_path)])


def test_pretrained_backbone_loads_torchvision_keys(tmp_path):
    """``--pretrained_backbone``: a raw torchvision ResNet state dict
    fills the backbone only (``fc.*`` and ``num_batches_tracked`` are
    ignored); an unmapped key raises."""
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.models.snipper import build_model
    from snipper_tpu_torch.train.checkpoint import (
        load_torchvision_backbone, torchvision_key_map)

    cfg = Config.tiny()
    key_map = torchvision_key_map(cfg)
    assert key_map["layer2.0.downsample.1.running_var"] == \
        "backbone.layer2_0.downsample_bn.running_var"
    src = build_model(cfg, device="cpu", seed=5).state_dict()
    tv = {k: src[v].clone() for k, v in key_map.items()}
    tv["fc.weight"] = torch.zeros(1000, 2048)
    tv["bn1.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path / "resnet.pth"
    torch.save(tv, path)

    model = build_model(cfg, device="cpu", seed=6)
    head = model.state_dict()["query_embed"].clone()
    assert load_torchvision_backbone(model, str(path), cfg) == len(key_map)
    got = model.state_dict()
    assert all(torch.equal(got[v], src[v]) for v in key_map.values())
    assert torch.equal(got["query_embed"], head)

    res = train_cli.main(ARGS + ["--epochs", "1", "--steps_per_epoch", "1",
                                 "--eval_every", "5", "--pretrained_backbone",
                                 str(path), "--output_dir",
                                 str(tmp_path / "run")])
    assert len(res["history"]) == 1

    tv["layer9.0.conv1.weight"] = torch.zeros(1)
    torch.save(tv, path)
    with pytest.raises(KeyError, match="unmapped torchvision key"):
        load_torchvision_backbone(model, str(path), cfg)
