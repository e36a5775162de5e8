"""The port's inference path against the JAX package's: host functions on
the same fixtures, and the two CLIs on the same original-repo checkpoint.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.infer import pipeline as jpipe
from snipper_tpu.infer.postprocess import \
    decode_predictions as jax_decode_predictions
from snipper_tpu_torch.cli import infer as port_cli
from snipper_tpu_torch.infer import pipeline as tpipe
from snipper_tpu_torch.infer.postprocess import decode_predictions
from test_torch_parity import TorchSnipper, _reference_state_dict


def _frames_dir(tmp_path, n=8, w=96, h=64, seed=0):
    d = tmp_path / "seq"
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        Image.fromarray(img).save(d / f"{i:06d}.jpg")
    return str(d)


def _assert_tracks_equal(a, b, atol=0.0):
    assert a["max_pid"] == b["max_pid"]
    assert set(a["frames"]) == set(b["frames"])
    for k in a["frames"]:
        pids_a, data_a = a["frames"][k]
        pids_b, data_b = b["frames"][k]
        assert list(pids_a) == list(pids_b), k
        np.testing.assert_allclose(data_a, data_b, rtol=1e-3 if atol else 0,
                                   atol=atol, err_msg=str(k))


def test_decode_predictions_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((8, 4, 2)).astype(np.float32)
    kpts = rng.uniform(0, 1, (8, 4, 15, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (8, 4, 15, 1)).astype(np.float32)
    got = decode_predictions(logits, kpts, depth, 15.0, (800.0, 600.0))
    want = jax_decode_predictions(logits, kpts, depth, 15.0, (800.0, 600.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _snippet_results(rng, n_snippets, T, nq=6, K=15):
    """Per-snippet decoded results; the detections of consecutive snippets
    overlap on their shared frame, so association matches some of them."""
    base = rng.uniform(50, 500, (nq, K, 2))
    results = []
    for s in range(n_snippets):
        kp = base[None] + rng.normal(0, 3, (T, nq, K, 2))
        results.append({
            "human_score": rng.uniform(0.2, 1.0, (nq, T)),
            "pred_kpt_scores": rng.uniform(0, 1, (nq, T, K, 1)),
            "pred_kpts": kp.transpose(1, 0, 2, 3),
            "pred_depth": rng.uniform(1, 10, (nq, T, K, 1)),
            "inv_trans": np.array([[1.0, 0, 2.0], [0, 1.0, -3.0]],
                                  np.float32),
            "img_size": np.array([800.0, 600.0], np.float32),
        })
    return results


@pytest.mark.parametrize("T,gap", [(4, 1), (4, 2), (1, 1)])
def test_associate_snippets_matches_jax(T, gap):
    rng = np.random.default_rng(T * 10 + gap)
    n = 5
    skip = gap if T == 1 else gap * (T - 1)
    frame_indices = list(range(0, n * skip, skip))
    all_files = [f"{i:06d}.jpg" for i in range(n * skip + T * gap)]
    results = _snippet_results(rng, n, T)
    for res, idx in zip(results, frame_indices):
        res["filenames"] = [all_files[idx + gap * t] for t in range(T)]
    got = tpipe.associate_snippets(results, frame_indices, all_files, T, gap,
                                   15.0)
    want = jpipe.associate_snippets(results, frame_indices, all_files, T,
                                    gap, 15.0)
    assert got[1] > 0
    _assert_tracks_equal({"frames": got[0], "max_pid": got[1]},
                         {"frames": want[0], "max_pid": want[1]})


def test_snippet_samples_match_jax(tmp_path):
    data_dir = _frames_dir(tmp_path, n=6, w=90, h=70)
    (tmp_path / "seq" / "notes.txt").write_text("not a frame")
    assert tpipe.snippet_index(data_dir, 3, 1) == \
        jpipe.snippet_index(data_dir, 3, 1)
    got = list(tpipe.iter_snippet_samples(data_dir, 3, 1, (64, 96)))
    want = list(jpipe.iter_snippet_samples(data_dir, 3, 1, (64, 96)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "filenames":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k])


def test_serve_snippets_reports_host_warp(tmp_path):
    """``host_warp`` names the warp that ran: the C++ one with a compiler,
    numpy without (the same frames reach the forward), the device's with
    ``device_preprocess``."""
    from unittest import mock

    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.data import native_ops

    cfg = Config.tiny()
    data_dir = _frames_dir(tmp_path, n=4)
    seen = []

    def forward(imgs):
        seen.append(imgs.clone())
        b, t = imgs.shape[:2]
        n, k = cfg.num_queries, cfg.num_kpts
        return {"pred_logits": torch.zeros(b, n, t, 2),
                "pred_kpts2d": torch.zeros(b, n, t, k, 3),
                "pred_depth": torch.zeros(b, n, t, k, 1)}

    def serve(device_preprocess=False):
        seen.clear()
        out = port_cli.serve_snippets(forward, cfg, data_dir, 1,
                                      torch.device("cpu"),
                                      device_preprocess=device_preprocess)
        assert out["snippets"] == len(seen) == 3
        return out["host_warp"], torch.cat(seen)

    if native_ops.have_native():
        kind, native = serve()
        assert kind == "native"
    else:
        native = None
    with mock.patch.object(native_ops, "_lib", False):
        kind, numpy_imgs = serve()
    assert kind == "numpy"
    if native is not None:
        assert torch.equal(native, numpy_imgs)
    kind, device_imgs = serve(device_preprocess=True)
    assert kind == "device" and device_imgs.shape == numpy_imgs.shape


def test_extract_video_frames_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    video = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 5, (32, 24))
    assert w.isOpened()
    for _ in range(3):
        w.write(rng.integers(0, 255, (24, 32, 3), np.uint8))
    w.release()
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    out_t.mkdir()
    (out_t / "000007.jpg").write_bytes(b"stale")
    assert tpipe.extract_video_frames(video, str(out_t)) == 3
    assert jpipe.extract_video_frames(video, str(out_j)) == 3
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in os.listdir(out_j):
        assert (out_t / name).read_bytes() == (out_j / name).read_bytes()


def test_prefetched_raises_iterator_errors():
    def broken():
        yield 1
        raise OSError("decode failed")

    it = tpipe.prefetched(broken())
    assert next(it) == 1
    with pytest.raises(OSError, match="decode failed"):
        next(it)


def test_cli_tiny_cpu_writes_tracks(tmp_path):
    data_dir = _frames_dir(tmp_path)
    out = str(tmp_path / "out")
    stats = port_cli.main(["--preset", "tiny", "--data_dir", data_dir,
                           "--seq_gap", "1", "--output_dir", out,
                           "--device", "cpu", "--snippet_batch", "2"])
    assert stats["snippets"] == 7 and len(stats["forward_ms"]) == 4
    with open(os.path.join(out, "tracks.pkl"), "rb") as f:
        tracks = pickle.load(f)
    assert set(tracks) == {"frames", "max_pid"}
    assert set(tracks["frames"]) == set(range(8))


def test_cli_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    data_dir = _frames_dir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["--preset", "tiny", "--data_dir", data_dir,
                       "--output_dir", str(tmp_path / "out")])


@pytest.mark.parametrize("flag", ["--data_parallel"])
def test_cli_refuses_flags_not_ported(tmp_path, capsys, flag, monkeypatch):
    """``--data_parallel``, once refused as not ported, is taken: outside
    ``torchrun`` it is the plain path (one process, the same tracks).
    Under ``torchrun``'s environment the CLI refuses to run without it,
    since every rank would serve and write every snippet."""
    data_dir = _frames_dir(tmp_path)
    tracks, served = {}, {}
    for extra in ([], [flag]):
        out = tmp_path / f"out{len(extra)}"
        served[len(extra)] = port_cli.main(
            ["--preset", "tiny", "--data_dir", data_dir, "--seq_gap", "1",
             "--output_dir", str(out), "--device", "cpu"] + extra)["snippets"]
        with open(out / "tracks.pkl", "rb") as f:
            tracks[len(extra)] = pickle.load(f)
    assert served[0] == served[1] == 7
    _assert_tracks_equal(tracks[0], tracks[1])
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit):
        port_cli.main(["--preset", "tiny", "--data_dir", data_dir,
                       "--device", "cpu"])
    assert "pass --data_parallel" in capsys.readouterr().err


def test_cli_tracks_match_jax_cli(tmp_path, monkeypatch):
    """The port CLI's tracks equal snipper_tpu.cli.infer's (exact
    deform_impl) on the same original-repo checkpoint."""
    import sys

    from snipper_tpu.cli import infer as jax_cli

    cfg = JaxConfig.tiny()
    torch.manual_seed(0)
    sd = _reference_state_dict(TorchSnipper(cfg).eval())
    ckpt = str(tmp_path / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               ckpt)
    data_dir = _frames_dir(tmp_path, n=7)
    common = ["--preset", "tiny", "--data_dir", data_dir, "--seq_gap", "1",
              "--pretrained_torch", ckpt]
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    port_cli.main(common + ["--output_dir", out_t, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["infer"] + common + [
        "--output_dir", out_j, "--deform_impl", "xla"])
    jax_cli.main()
    tracks = []
    for out in (out_t, out_j):
        with open(os.path.join(out, "tracks.pkl"), "rb") as f:
            tracks.append(pickle.load(f))
    assert tracks[1]["max_pid"] > 0
    # pixel coordinates: ~1e-6 normalized float differences -> ~1e-4 px
    _assert_tracks_equal(tracks[0], tracks[1], atol=5e-3)
