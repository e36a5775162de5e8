"""The port's device warp and ``cli.infer --device_preprocess`` /
``--save_visuals`` against the JAX package's.

``warp_affine_device`` is held against JAX's within 1e-5 (the same f32
taps; JAX sums two-term dot products where the port adds two products)
and against the port's numpy host warp within 2e-3 (the JAX test's
tolerance: the host warp interpolates in f64 coordinates). The CLIs run on
the same original-repo checkpoint at the tiny preset, on frames of another
size than the model's input, so that the warp resizes.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snipper_tpu.data import device_preprocess as jdev
from snipper_tpu.infer import pipeline as jpipe
from snipper_tpu_torch.cli import infer as port_cli
from snipper_tpu_torch.data import device_preprocess as tdev
from snipper_tpu_torch.data.transforms import (gen_trans_from_patch,
                                               generate_patch_image,
                                               warp_affine)
from snipper_tpu_torch.infer import pipeline as tpipe
from test_torch_port_infer import _assert_tracks_equal, _frames_dir


def _centre_trans(h, w, out_h, out_w):
    scale = max(w / out_w, h / out_h)
    return gen_trans_from_patch(w / 2, h / 2, out_w * scale, out_h * scale,
                                out_w, out_h, 0.0)


def _case(name):
    """(uint8 frames, forward affine, out shape, do_flip)."""
    if name == "zoom_out_border":
        # zoom out, so the output needs samples outside the source
        img = np.random.default_rng(1).integers(0, 256, (20, 20, 3),
                                                np.uint8)
        return img, gen_trans_from_patch(10.0, 10.0, 60.0, 60.0, 24, 24,
                                         0.0), (24, 24), False
    if name == "flip":
        img = np.random.default_rng(2).integers(0, 256, (30, 44, 3),
                                                np.uint8)
        return img, gen_trans_from_patch(20.0, 16.0, 50.0, 36.0, 32, 24,
                                         0.0), (24, 32), True
    # a batched snippet [T, H, W, 3], centre crop-resize
    imgs = np.random.default_rng(3).integers(0, 256, (4, 36, 60, 3),
                                             np.uint8)
    return imgs, _centre_trans(36, 60, 24, 40), (24, 40), False


@pytest.mark.parametrize("name", ["zoom_out_border", "flip", "batched"])
def test_warp_matches_jax_and_host_warp(name):
    imgs, trans, out_shape, flip = _case(name)
    inv = tdev.invert_axis_aligned(trans)
    got = tdev.warp_affine_device(torch.from_numpy(imgs), inv, out_shape,
                                  do_flip=flip).numpy()
    want = np.asarray(jdev.warp_affine_device(
        jnp.asarray(imgs), jnp.asarray(jdev.invert_axis_aligned(trans)),
        out_shape, do_flip=flip))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    frames = imgs.reshape(-1, *imgs.shape[-3:])
    host = np.stack([generate_patch_image(f, flip, trans, out_shape)
                     for f in frames]).reshape(got.shape)
    np.testing.assert_allclose(got, host, rtol=0, atol=2e-3)
    if name == "zoom_out_border":
        assert np.all(got[0, 0] == 0.0) and np.all(got[-1, -1] == 0.0)
        np.testing.assert_allclose(
            got, warp_affine(imgs, trans, out_shape) / 255.0, atol=2e-3)


def test_preprocess_snippet_device_matches_jax():
    imgs, trans, out_shape, _ = _case("batched")
    got = tdev.preprocess_snippet_device(imgs, trans, out_shape).numpy()
    want = np.asarray(jdev.preprocess_snippet_device(imgs, trans,
                                                     out_shape))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_invert_axis_aligned_matches_jax_and_rejects_rotation():
    trans = _centre_trans(600, 800, 600, 800)
    for t in (trans, gen_trans_from_patch(33.0, 21.0, 70.0, 50.0, 96, 64,
                                          0.0)):
        np.testing.assert_array_equal(tdev.invert_axis_aligned(t),
                                      jdev.invert_axis_aligned(t))
    rotated = gen_trans_from_patch(33.0, 21.0, 70.0, 50.0, 96, 64, 10.0)
    with pytest.raises(ValueError, match="axis-aligned"):
        tdev.invert_axis_aligned(rotated)
    with pytest.raises(AssertionError):
        jdev.invert_axis_aligned(rotated)
    with pytest.raises(ValueError, match="axis-aligned"):
        tdev.warp_affine_device(torch.zeros(4, 4, 3), np.array(
            [[1.0, 0.1, 0.0], [0.0, 1.0, 0.0]]), (4, 4))


def test_snippet_samples_warp_on_device_match_jax(tmp_path):
    data_dir = _frames_dir(tmp_path, n=5, w=90, h=70)
    kw = dict(warp_on_device=True)
    got = list(tpipe.iter_snippet_samples(data_dir, 2, 1, (64, 96), **kw))
    want = list(jpipe.iter_snippet_samples(data_dir, 2, 1, (64, 96), **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) and "imgs" not in g
        assert g["raw_imgs"].dtype == np.uint8
        for k in w:
            if k == "filenames":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _tracks(out):
    with open(os.path.join(out, "tracks.pkl"), "rb") as f:
        return pickle.load(f)


class _JitApply:
    """A flax module whose ``apply`` is jitted (``return_attn`` static)."""

    def __init__(self, module):
        self._module = module
        self.apply = jax.jit(module.apply, static_argnames=("return_attn",))

    def __getattr__(self, name):
        return getattr(self._module, name)


@pytest.fixture(scope="module")
def device_runs(tmp_path_factory):
    """``cli.infer --device_preprocess --save_visuals
    --vis_heatmap_frame_name`` of both packages on one original-repo
    checkpoint (JAX with its exact ``xla`` sampling), over 4 frames of
    72x100 (the warp resizes them to 64x96)."""
    from snipper_tpu.cli import infer as jax_cli
    from snipper_tpu.config import Config as JaxConfig
    from test_torch_parity import TorchSnipper, _reference_state_dict

    tmp = tmp_path_factory.mktemp("device_preprocess")
    torch.manual_seed(0)
    sd = _reference_state_dict(TorchSnipper(JaxConfig.tiny()).eval())
    ckpt = str(tmp / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               ckpt)
    data_dir = _frames_dir(tmp, n=4, w=100, h=72)
    common = ["--preset", "tiny", "--data_dir", data_dir, "--seq_gap", "1",
              "--pretrained_torch", ckpt, "--device_preprocess"]
    vis = ["--save_visuals", "--vis_heatmap_frame_name", "000002.jpg"]
    out_t, out_j = str(tmp / "port"), str(tmp / "jax")
    stats = port_cli.main(common + vis + ["--output_dir", out_t, "--device",
                                          "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["infer"] + common + vis + [
            "--output_dir", out_j, "--deform_impl", "xla"])
        # the visuals' forward (return_attn) runs jitted, not op by op
        real_build = jax_cli.build_model
        mp.setattr(jax_cli, "build_model",
                   lambda cfg: _JitApply(real_build(cfg)))
        jax_cli.main()
    return dict(common=common, tmp=tmp, stats=stats, port=out_t, jax=out_j)


def test_cli_device_preprocess_tracks_match_jax(device_runs):
    assert device_runs["stats"]["snippets"] == 3
    want = _tracks(device_runs["jax"])
    assert want["max_pid"] > 0
    # pixel coordinates: ~1e-6 normalized float differences -> ~1e-4 px
    _assert_tracks_equal(_tracks(device_runs["port"]), want, atol=5e-3)


def test_cli_save_visuals_writes_jax_files(device_runs):
    files = _files(device_runs["port"])
    assert files == _files(device_runs["jax"])
    assert "heatmaps/heatmap_000002.jpg" in files
    assert "attention/attention_t0.jpg" in files
    assert "pose_tracking.gif" in files


def test_cli_device_preprocess_snippet_batch(device_runs):
    """Two snippets per forward, warped and stacked on the device (the
    tail padded there): the batch-1 tracks."""
    out = str(device_runs["tmp"] / "port_b2")
    stats = port_cli.main(device_runs["common"] + [
        "--output_dir", out, "--device", "cpu", "--snippet_batch", "2"])
    assert stats["snippets"] == 3 and len(stats["forward_ms"]) == 2
    _assert_tracks_equal(_tracks(out), _tracks(device_runs["port"]),
                         atol=5e-3)


def test_vis_heatmap_frame_name_alone_errors_as_jax(tmp_path, capsys,
                                                    monkeypatch):
    from snipper_tpu.cli import infer as jax_cli

    argv = ["--preset", "tiny", "--data_dir", str(tmp_path),
            "--vis_heatmap_frame_name", "000001.jpg"]
    with pytest.raises(SystemExit) as e:
        port_cli.main(argv + ["--device", "cpu"])
    port_err = capsys.readouterr().err.splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["infer"] + argv)
    with pytest.raises(SystemExit) as ej:
        jax_cli.main()
    jax_err = capsys.readouterr().err.splitlines()[-1]
    assert e.value.code == ej.value.code == 2
    assert "requires --save_visuals" in port_err
    assert port_err.split(": ", 1)[1] == jax_err.split(": ", 1)[1]
