"""The port's multi-process paths on two gloo ranks of the CPU, against the
JAX package's mesh and against the port's own single process.

One launch of two ranks (``multihost.spawn``) runs every two-rank
scenario of this module (``_torch_parallel_ranks.two_ranks``) while this
process computes the references: JAX's ``make_train_step`` on
``make_mesh(dp_size=2)`` with the global batch of 4, and the port's
single-process eval, serving and training runs. Everything is f32 with
dropout 0 at the tiny preset.
"""

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.losses.criterion import SetCriterion as JaxCriterion
from snipper_tpu.models import snipper as jsnipper
from snipper_tpu.parallel.mesh import make_mesh as jax_make_mesh
from snipper_tpu.train.state import create_train_state as jax_train_state
from snipper_tpu.train.state import mask_frozen_grads
from snipper_tpu.train.step import make_train_step, replicate, shard_batch
from snipper_tpu_torch.cli import infer as infer_cli
from snipper_tpu_torch.cli import train as train_cli
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.data.loader import DataLoader
from snipper_tpu_torch.data.snippet import stack_batch
from snipper_tpu_torch.data.synthetic import SyntheticDataset
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.parallel import multihost
from snipper_tpu_torch.parallel.mesh import make_mesh
from snipper_tpu_torch.scripts import probe
from snipper_tpu_torch.train.checkpoint import load_checkpoint
from snipper_tpu_torch.train.engine import evaluate

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_ranks as ranks  # noqa: E402
from test_torch_port_train import TINY, _random_params  # noqa: E402

CPU = torch.device("cpu")


def _write_frames(d, n=5, w=96, h=64, seed=0):
    from PIL import Image

    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(d, f"{i:06d}.jpg"))
    return d


def _jax_step(jcfg, params, host):
    """JAX's loss, grad norm and updated params of one f32 step on
    ``make_mesh(dp_size=2)`` (the CLI's criterion: ``dp_size`` 2), and
    its gradients on one device."""
    jm = jsnipper.build_model(jcfg)
    crit = JaxCriterion(jcfg, dp_size=2)
    jbatch = {"images": jnp.asarray(host["images"]),
              "targets": jax.tree_util.tree_map(jnp.asarray,
                                                host["targets"])}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p):
        return crit(jm.apply({"params": p}, jbatch["images"]),
                    jbatch["targets"])[0]

    grads = mask_frozen_grads(jax.jit(jax.grad(jloss))(jparams))
    mesh = jax_make_mesh(dp_size=2)
    state, tx = jax_train_state(jcfg, jparams, steps_per_epoch=10)
    step = make_train_step(jm, crit, tx, donate=False,
                           mixed_precision=False)
    state, metrics = step(replicate(state, mesh), shard_batch(jbatch, mesh),
                          jax.random.PRNGKey(0))
    return {"loss": float(metrics["loss_total"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": state_dict_from_jax(jax.device_get(grads)),
            "params": state_dict_from_jax(jax.device_get(state.params))}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """``(rank results, references)``: the two ranks' suite, run beside
    this process's references."""
    root = tmp_path_factory.mktemp("parallel")
    jcfg = JaxConfig.tiny().replace(**TINY)
    cfg = Config.tiny().replace(**TINY)
    jm = jsnipper.build_model(jcfg)
    x = jnp.zeros((1, jcfg.num_frames, jcfg.input_height, jcfg.input_width,
                   3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    params = _random_params(shapes["params"], 5)
    sd = state_dict_from_jax(params)
    ds = SyntheticDataset(cfg, n_samples=4, seed=0)
    host = stack_batch([ds[i] for i in range(4)])
    ckpt = str(root / "tiny.pt")
    torch.save({"params": sd, "step": 0}, ckpt)
    frames = _write_frames(str(root / "frames"))
    inp = {
        "state_dict": sd, "batch": {k: v for k, v in host.items()
                                    if k != "meta"},
        "out": str(root),
        "infer_argv": ["--preset", "tiny", "--data_dir", frames,
                       "--seq_gap", "1", "--resume", ckpt, "--device",
                       "cpu"],
        "train_argv": ["--preset", "tiny", "--synthetic",
                       "--synthetic_samples", "2", "--epochs", "1",
                       "--steps_per_epoch", "1", "--eval_every", "2",
                       "--batch_size", "1", "--dropout", "0",
                       "--num_workers", "0", "--no-mixed_precision",
                       "--device", "cpu"]}
    # the CLI as a user starts it: torchrun's environment, two ranks
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc_per_node", "2", "-m",
                "snipper_tpu_torch.cli.infer", *inp["infer_argv"],
                "--data_parallel", "--output_dir", str(root / "torchrun_b1")]
    with ThreadPoolExecutor(2) as pool:
        launch = pool.submit(multihost.spawn, ranks.two_ranks, 2, (inp,),
                             timeout_s=300)
        cli = pool.submit(subprocess.run, torchrun, cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
        ref = {"jax": _jax_step(jcfg, params, host), "serve": {}}
        for gsz in ("1", "2"):
            out = str(root / f"single_b{gsz}")
            ref["serve"][gsz] = infer_cli.main(
                inp["infer_argv"] + ["--snippet_batch", gsz,
                                     "--output_dir", out])["snippets"]
        ref["train"] = train_cli.main(
            inp["train_argv"] + ["--output_dir", str(root / "single")])
        # single-process eval of the global batches of 2: the CLI's
        # criterion at dp_size 2 (the ranks' average of their bare sums)
        ecfg = Config.tiny().replace(dropout=0.0, batch_size=2)
        model = build_model(ecfg, device="cpu")
        model.load_state_dict(sd)
        ref["eval"] = evaluate(
            model, SetCriterion(ecfg, dp_size=2),
            DataLoader(SyntheticDataset(ecfg, n_samples=4, seed=1), 2,
                       shuffle=False, drop_last=False), ecfg, CPU,
            collect_results=True)
        res = launch.result()
        ref["torchrun"] = cli.result()
    ref["root"] = root
    return res, ref


def test_all_gather_objects_in_rank_order(two):
    res, _ = two
    for r in res:
        assert [g["rank"] for g in r["gather"]] == [0, 1]
        assert [len(g["payload"]) for g in r["gather"]] == [1, 701]
        assert r["merged"] == [{"rank": 0, "i": 0}, {"rank": 0, "i": 1},
                               {"rank": 1, "i": 0}]
        assert r["broadcast"] == {"from": 0}


def test_dp_step_matches_jax_mesh(two):
    """Two ranks of batch 2 against ``make_train_step`` on a dp2 mesh with
    the global batch of 4: the loss, the gradients and the updated
    parameters at ``test_train_step_matches_jax``'s tolerances; both
    ranks hold the same gradients and parameters."""
    res, ref = two
    want = ref["jax"]
    for r in res:
        got = r["dp_step"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        g_max = max(np.abs(g).max() for g in got["grads"].values())
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, want["grads"][name].numpy(),
                                       rtol=1e-4, atol=1e-5 * g_max,
                                       err_msg=name)
        for name, v in got["params"].items():
            np.testing.assert_allclose(v, want["params"][name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
    for name, v in res[0]["dp_step"]["params"].items():
        np.testing.assert_array_equal(v, res[1]["dp_step"]["params"][name])


def test_stop_flag_on_one_rank_stops_both(two):
    res, _ = two
    for r in res:
        assert r["stop"]["loader_len"] == 4
        assert r["stop"]["steps"] == 1 and r["stop"]["should_stop"]


def test_eval_merge_matches_single_process(two):
    """``evaluate`` on two ranks of batch 1 over 4 samples: every stat
    within 1e-6 of one process over the global batches of 2, and the
    merged results (rank order: samples 0, 2, then 1, 3) equal its."""
    res, ref = two
    want = ref["eval"]
    for r in res:
        got = r["eval"]
        assert got["_batches"] == 2
        stats = {k for k in want if not k.startswith("_")}
        assert stats == {k for k in got if not k.startswith("_")}
        assert "loss_total" in stats
        for k in stats:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        order = [0, 2, 1, 3]
        assert len(got["_results"]) == 4
        for i, g in zip(order, got["_results"]):
            w = want["_results"][i]
            assert set(g) == set(w)
            for k in ("pred_kpts", "pred_kpt_scores", "human_score"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gsz,run", [("1", "dp"), ("2", "dp"),
                                     ("1", "torchrun")])
def test_data_parallel_serving_matches_single_process(two, gsz, run):
    """``cli.infer --data_parallel --device cpu`` on two ranks writes the
    single process's ``tracks.pkl`` (each rank serves every other group of
    ``--snippet_batch`` snippets; the last group is padded): in the
    spawned group, and started by ``torchrun`` (gloo from its
    environment)."""
    res, ref = two
    if run == "torchrun":
        proc = ref["torchrun"]
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "process group: gloo, world 2, rank 0 on cpu" in proc.stdout
        assert "data-parallel over 2 ranks" in proc.stdout
    else:
        assert ref["serve"][gsz] == res[0]["serve"][gsz] \
            == res[1]["serve"][gsz]
    tracks = {}
    for name in ("single", run):
        with open(ref["root"] / f"{name}_b{gsz}" / "tracks.pkl", "rb") as f:
            tracks[name] = pickle.load(f)
    a, b = tracks["single"], tracks[run]
    assert a["max_pid"] == b["max_pid"]
    assert set(a["frames"]) == set(b["frames"])
    for k, (pids, data) in a["frames"].items():
        assert list(b["frames"][k][0]) == list(pids)
        np.testing.assert_allclose(b["frames"][k][1], data, rtol=1e-5,
                                   atol=1e-4)


def test_tp2_checkpoint_is_the_single_process_one(two, tmp_path):
    """``cli.train --tp_size 2`` (f32) on two ranks writes full tensors:
    the checkpoint holds the single process's AdamW moments (rtol 1e-4,
    atol 1e-5 of each tensor's largest: the gradients' bound) and
    parameters (``test_train_step_matches_jax``'s rtol 1e-4, atol 1e-6)
    after the same step, and ``cli.infer --resume`` loads it unchanged."""
    res, ref = two
    tp2 = load_checkpoint(res[0]["tp2_checkpoint"])
    single = load_checkpoint(ref["train"]["checkpoint"])
    assert res[0]["tp2_checkpoint"] == res[1]["tp2_checkpoint"]
    np.testing.assert_allclose(res[0]["tp2_loss"],
                               ref["train"]["history"][0]["loss_total"],
                               rtol=1e-5)
    assert tp2["step"] == single["step"] == 1
    want = single["opt_state"]["adamw"]["state"]
    got = tp2["opt_state"]["adamw"]["state"]
    assert set(got) == set(want)
    for i, s in want.items():
        for k in ("exp_avg", "exp_avg_sq"):
            g_max = s[k].abs().max().item()
            np.testing.assert_allclose(got[i][k].numpy(), s[k].numpy(),
                                       rtol=1e-4, atol=1e-5 * g_max,
                                       err_msg=f"{i} {k}")
    assert set(tp2["params"]) == set(single["params"])
    for k, v in single["params"].items():
        assert tp2["params"][k].shape == v.shape, k
        np.testing.assert_allclose(tp2["params"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    frames = _write_frames(str(tmp_path / "frames"), n=3)
    stats = infer_cli.main(["--preset", "tiny", "--data_dir", frames,
                            "--seq_gap", "1", "--device", "cpu",
                            "--resume", res[0]["tp2_checkpoint"],
                            "--output_dir", str(tmp_path / "out")])
    assert stats["snippets"] == 2
    assert (tmp_path / "out" / "tracks.pkl").exists()


def test_single_process_issues_no_collective():
    """Without a process group: a 1 x 1 mesh with no groups, and the
    helpers take their single-process paths."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.dp, mesh.tp, mesh.rank) == (1, 1, 0)
    assert mesh.data_group is None and mesh.model_group is None
    assert multihost.process_count() == 1 and multihost.is_main_process()
    assert multihost.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert multihost.merge_eval_results([{"a": 1}]) == [{"a": 1}]
    assert multihost.any_process(True) and not multihost.any_process(False)
    assert multihost.broadcast_object(3) == 3


@pytest.mark.parametrize("dp,tp", [(-1, 2), (2, 1), (0, 1), (1, 0)])
def test_make_mesh_refuses_what_jax_refuses(dp, tp):
    """JAX's checks: ``dp_size = -1`` needs a world that ``tp_size``
    divides, and the mesh must fit the world (here, one process)."""
    with pytest.raises(ValueError):
        make_mesh(dp, tp)


@pytest.mark.parametrize("devices", [None, 4])
def test_probe_meshscale_cpu(capsys, devices):
    """``probe meshscale --device cpu``: the CPU is one device, so n=1
    runs and n=4, n=8 print their skipped lines; ``--devices 4`` spreads
    n=4 over four gloo ranks, each holding one row of the global batch."""
    extra = [] if devices is None else ["--devices", str(devices)]
    assert probe.main(["meshscale", "--device", "cpu", "--preset", "tiny",
                       "-K", "1"] + extra) == 0
    out = capsys.readouterr().out.splitlines()
    n_dev = devices or 1
    assert out[0] == (f"meshscale probe on cpu: tiny 64x96, f32 forward, "
                      f"{n_dev} devices")
    assert out[1].startswith("n=1: ") and "overhead-eff 1.000" in out[1]
    if devices:
        assert out[2].startswith("n=4: ") and "/ global batch 4" in out[2]
        assert "overhead-eff" in out[2]
    else:
        assert out[2] == "n=4: skipped (1 devices)"
    assert out[3:] == [f"n=8: skipped ({n_dev} devices)", "DONE"]
    assert "FAIL" not in "\n".join(out)
