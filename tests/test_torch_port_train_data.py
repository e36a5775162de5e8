"""Training from reference-format files with the warp on the device,
against the JAX package: ``warp_train_batch_device`` against JAX's within
1e-5 and against the host ``warp_patch`` within 2e-3 (rotation, flip,
color clip, zero padding); ``device_prefetch``'s order, completeness and
early break; one f32 train step (dropout 0) on a real-loader batch of raw
frames against JAX's step with the same params, loss within 1e-4;
``cli.train --posetrack_dir ... --device_preprocess --device cpu`` for
two tiny steps and a checkpoint; and ``build_dataset``'s
``device_preprocess`` on the synthetic set and on dataset directories.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.data import device_preprocess as jdp
from snipper_tpu.data.datasets import HybridDataset as JaxHybrid
from snipper_tpu.data.loader import DataLoader as JaxLoader
from snipper_tpu.data.native_ops import warp_patch as jax_warp_patch
from snipper_tpu.data.transforms import fold_flip_inverse, \
    gen_trans_from_patch
from snipper_tpu.losses.criterion import SetCriterion as JaxCriterion
from snipper_tpu.models import snipper as jsnipper
from snipper_tpu.train.state import create_train_state as jax_train_state
from snipper_tpu.train.step import make_train_step
from snipper_tpu_torch.cli import train as train_cli
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.data.datasets import HybridDataset
from snipper_tpu_torch.data.device_preprocess import warp_train_batch_device
from snipper_tpu_torch.data.loader import DataLoader, device_prefetch
from snipper_tpu_torch.data.native_ops import warp_patch
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.train.checkpoint import load_checkpoint
from snipper_tpu_torch.train.state import create_train_state
from snipper_tpu_torch.train.step import batch_to_device, train_step
from test_torch_port_datasets import WARP_CASES, posetrack_fixture  # noqa
from test_torch_port_train import _random_params

CPU = torch.device("cpu")
TOL_WARP_JAX = 1e-5
TOL_WARP_HOST = 2e-3
TOL_LOSS = 1e-4


# ---------------------------------------------------------- the train warp
@pytest.mark.parametrize("pad", [(0, 0), (34, 20)])
def test_train_warp_matches_jax_and_host(pad):
    """The four rotation/flip/color cases of
    tests/test_device_preprocess.py, zoomed out so taps cross the border,
    frames zero-padded by ``pad``: within 1e-5 of JAX's device warp on the
    same padded batch, within 2e-3 of the port's host ``warp_patch`` and of
    JAX's."""
    rng = np.random.default_rng(3)
    H, W, out_h, out_w = 40, 56, 32, 48
    raws, invs, colors, hosts = [], [], [], []
    for rot, do_flip, color in WARP_CASES:
        img = rng.integers(0, 256, (H, W, 3), np.uint8)
        scale = max(W / out_w, H / out_h) * rng.uniform(0.8, 1.6)
        cx, cy = W * rng.uniform(0.4, 0.6), H * rng.uniform(0.4, 0.6)
        trans = gen_trans_from_patch(cx, cy, out_w * scale, out_h * scale,
                                     out_w, out_h, rot)
        host = warp_patch(img, trans, (out_h, out_w), do_flip, color)
        np.testing.assert_allclose(
            host, jax_warp_patch(img, trans, (out_h, out_w), do_flip, color),
            rtol=0, atol=1e-5)
        hosts.append(host)
        raw = np.zeros((2, H + pad[0], W + pad[1], 3), np.uint8)
        raw[:, :H, :W] = img
        raws.append(raw)
        invs.append(np.repeat(fold_flip_inverse(trans, do_flip, W)[None],
                              2, 0))
        colors.append(np.asarray(color, np.float32))
    raw, inv, color = np.stack(raws), np.stack(invs), np.stack(colors)
    got = warp_train_batch_device(torch.from_numpy(raw),
                                  torch.from_numpy(inv),
                                  torch.from_numpy(color), (out_h, out_w))
    want = np.asarray(jdp.warp_train_batch_device(
        jnp.asarray(raw), jnp.asarray(inv), jnp.asarray(color),
        (out_h, out_w)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_WARP_JAX)
    for b, host in enumerate(hosts):
        for t in range(2):
            np.testing.assert_allclose(got[b, t].numpy(), host, rtol=0,
                                       atol=TOL_WARP_HOST)
    assert got.min() >= 0.0 and got.max() == 1.0  # the color clip bites


# ---------------------------------------------------------- device_prefetch
@pytest.mark.parametrize("n", [0, 1, 5])
def test_device_prefetch_order_and_completeness(n):
    """Every batch comes out once, in order, and the next batch's ``put``
    is issued before the current batch is handed out."""
    events = []

    def source():
        for i in range(n):
            events.append(("load", i))
            yield i

    def put(i):
        events.append(("put", i))
        return {"x": torch.tensor([i])}

    out = []
    for b in device_prefetch(source(), put):
        events.append(("step", int(b["x"])))
        out.append(int(b["x"]))
    assert out == list(range(n))
    for i in range(n - 1):
        assert events.index(("put", i + 1)) < events.index(("step", i))
    assert [e for e in events if e[0] == "put"] == \
        [("put", i) for i in range(n)]


def test_device_prefetch_early_break():
    """A consumer that stops after two batches has issued at most one
    ``put`` beyond them and leaves the source closed."""
    puts, closed = [], []

    def source():
        try:
            for i in range(100):
                yield i
        finally:
            closed.append(True)

    it = device_prefetch(source(), lambda i: puts.append(i) or i)
    got = [b for _, b in zip(range(2), it)]
    it.close()
    assert got == [0, 1] and puts == [0, 1, 2] and closed == [True]


# ------------------------------------------------- a step from raw frames
TINY = dict(dropout=0.0, batch_size=2)


def test_train_step_from_raw_frames_matches_jax(posetrack_fixture):  # noqa
    """One f32 step on the first batch the two packages' loaders give from
    the posetrack fixture with ``device_preprocess=True``: raw frames
    bitwise and ``warp_inv`` within 1e-6, then the loss (which warps inside
    the step) within 1e-4 relative of JAX's ``make_train_step`` with the
    same params."""
    jcfg = JaxConfig.tiny().replace(**TINY)
    cfg = Config.tiny().replace(**TINY)
    kw = dict(shuffle=True, seed=2, process_index=0, process_count=1)
    host = next(iter(DataLoader(HybridDataset(
        cfg, "train", posetrack_dir=posetrack_fixture, seed=1,
        device_preprocess=True), 2, **kw)))
    jhost = next(iter(JaxLoader(JaxHybrid(
        jcfg, "train", posetrack_dir=posetrack_fixture, seed=1,
        device_preprocess=True), 2, **kw)))
    np.testing.assert_array_equal(host["raw_images"], jhost["raw_images"])
    np.testing.assert_allclose(host["warp_inv"], jhost["warp_inv"], rtol=0,
                               atol=1e-6)
    assert host["raw_images"].shape[2] % 128 == 0

    jm = jsnipper.build_model(jcfg)
    x = jnp.zeros((1, jcfg.num_frames, jcfg.input_height, jcfg.input_width,
                   3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x))["params"]
    params = _random_params(shapes, 7)
    jbatch = {k: jnp.asarray(jhost[k])
              for k in ("raw_images", "warp_inv", "color_scale")}
    jbatch["targets"] = {k: jnp.asarray(v)
                         for k, v in jhost["targets"].items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state, tx = jax_train_state(jcfg, jparams, steps_per_epoch=10)
    step = make_train_step(jm, JaxCriterion(jcfg), tx, donate=False,
                           mixed_precision=False)
    _, j_metrics = step(state, jbatch, jax.random.PRNGKey(0))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    tstate = create_train_state(cfg, model, steps_per_epoch=10)
    metrics = train_step(tstate, SetCriterion(cfg),
                         batch_to_device(host, CPU),
                         torch.Generator().manual_seed(0),
                         mixed_precision=False)
    assert "images" not in host
    np.testing.assert_allclose(metrics["loss_total"].item(),
                               float(j_metrics["loss_total"]),
                               rtol=TOL_LOSS)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(j_metrics["grad_norm"]), rtol=1e-3)


# ------------------------------------------------------------- the CLI
def test_cli_train_on_posetrack_files(tmp_path, capsys,
                                      posetrack_fixture):  # noqa
    """``cli.train --posetrack_dir --device_preprocess`` on the CPU: two
    tiny steps from the reference-format files with the warp inside the
    step, a checkpoint, and the eval on the val split (always warped on
    the host)."""
    res = train_cli.main([
        "--preset", "tiny", "--posetrack_dir", posetrack_fixture,
        "--device_preprocess", "--device", "cpu", "--epochs", "1",
        "--steps_per_epoch", "2", "--num_workers", "2", "--output_dir",
        str(tmp_path)])
    assert "NOTE" not in capsys.readouterr().out
    assert len(res["history"]) == 2
    for h in res["history"]:
        assert np.isfinite(h["loss_total"]) and h["data_seconds"] >= 0
    ckpt = tmp_path / "ckpts" / "checkpoint0000.pt"
    assert res["checkpoint"] == str(ckpt) and ckpt.exists()
    assert load_checkpoint(str(ckpt))["step"] == 2
    assert np.isfinite(res["eval"]["loss_total"])
    assert res["eval"]["_batches"] == 3  # the val listing, batches of 1
    assert os.path.exists(tmp_path / "log.txt")


@pytest.mark.parametrize("synthetic", [True, False])
def test_build_dataset_device_preprocess(synthetic, capsys,
                                         posetrack_fixture):  # noqa
    """``build_dataset(..., device_preprocess=True)``: on the synthetic set
    it prints the JAX CLI's NOTE and renders warped frames; on dataset
    directories it gives the raw record."""
    from snipper_tpu_torch.cli.common import build_dataset

    args = train_cli.build_parser().parse_args(
        ["--preset", "tiny", "--synthetic_samples", "2"]
        + (["--synthetic"] if synthetic else
           ["--posetrack_dir", posetrack_fixture]))
    ds = build_dataset(Config.tiny(), args, "train", device_preprocess=True)
    note = "NOTE: --device_preprocess ignored for the synthetic dataset"
    assert (note in capsys.readouterr().out) == synthetic
    assert ("images" in ds[0]) == synthetic
    assert ("raw_images" in ds[0]) != synthetic
