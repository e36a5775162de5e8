"""The port's eval slice against the JAX package's: ``cli.eval`` and
``evaluate(collect_results=True)`` on one original-repo checkpoint at the
tiny preset, the PoseTrack/COCO harness on the fixtures of
``tests/test_posetrack_eval.py`` and ``tests/test_coco_eval.py``, and the
render module on those of ``tests/test_visualize.py``.

The CLIs run in f32 on the CPU, JAX with its exact ``xla`` sampling; their
numbers agree within 1e-4 relative (f32 sums in other orders through the
network). The harness is host numpy in both packages: the same numbers.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import test_coco_eval as tc
import test_posetrack_eval as tp
import test_visualize as tv
from snipper_tpu.eval import coco_eval as jcoco
from snipper_tpu.eval import posetrack_eval as jpt
from snipper_tpu.eval import posetrack_writer as jwriter
from snipper_tpu.infer import visualize as jvis
from snipper_tpu_torch.cli import eval as eval_cli
from snipper_tpu_torch.eval import coco_eval as tcoco
from snipper_tpu_torch.eval import posetrack_eval as tpt
from snipper_tpu_torch.eval import posetrack_writer as twriter
from snipper_tpu_torch.infer import visualize as tvis

J = 15


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same(got, want, path="", rtol=0.0):
    """Equal structure; numbers equal (NaN where NaN), or within ``rtol``."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}", rtol)
    elif isinstance(want, (list, tuple)) and want and not np.isscalar(
            want[0]) and not isinstance(want[0], (int, float, bool)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]", rtol)
    elif isinstance(want, str):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=rtol,
                                   atol=0, equal_nan=True, err_msg=path)


# ------------------------------------------------------------ the eval CLI
ARGS = ["--preset", "tiny", "--synthetic", "--synthetic_samples", "4",
        "--num_workers", "0", "--deform_impl", "xla", "--save_vis",
        "--write_posetrack"]


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """``cli.eval`` of both packages on one original-repo checkpoint, with
    each ``evaluate``'s return value (its ``_results``) captured."""
    from snipper_tpu.cli import eval as jax_cli
    from snipper_tpu.config import Config as JaxConfig
    from test_torch_parity import TorchSnipper, _reference_state_dict

    tmp = tmp_path_factory.mktemp("eval")
    torch.manual_seed(0)
    sd = _reference_state_dict(TorchSnipper(JaxConfig.tiny()).eval())
    ckpt = str(tmp / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               ckpt)
    out_t, out_j = str(tmp / "port"), str(tmp / "jax")
    captured = {}

    def spy(name, real):
        def run(*a, **kw):
            stats = real(*a, **kw)
            captured[name] = list(stats["_results"])
            return stats
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eval_cli, "evaluate", spy("port", eval_cli.evaluate))
        mp.setattr(jax_cli, "evaluate", spy("jax", jax_cli.evaluate))
        res = eval_cli.main(ARGS + ["--pretrained_torch", ckpt,
                                    "--output_dir", out_t, "--device",
                                    "cpu"])
        mp.setattr(sys, "argv", ["eval"] + ARGS + [
            "--pretrained_torch", ckpt, "--output_dir", out_j])
        jax_cli.main()
    return dict(res=res, port=out_t, jax=out_j, results=captured)


def test_eval_stats_match_jax(eval_runs):
    stats = []
    for out in (eval_runs["port"], eval_runs["jax"]):
        with open(os.path.join(out, "eval_stats.json")) as f:
            stats.append(json.load(f))
    got, want = stats
    assert set(got) == set(want)
    assert {"loss_total", "mpjpe_joint", "future_3dpck"} <= set(got)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert eval_runs["res"]["batches"] == 4
    assert len(eval_runs["res"]["batch_ms"]) == 4


def test_evaluate_collect_results_match_jax(eval_runs):
    got, want = eval_runs["results"]["port"], eval_runs["results"]["jax"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g["indices"], w["indices"]):
            np.testing.assert_array_equal(a, b)
        for k in ("pred_kpts", "human_score", "pred_depth", "gt_kpts"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_eval_writes_jax_files(eval_runs):
    files = _files(eval_runs["port"])
    assert files == _files(eval_runs["jax"])
    assert "eval_vis/eval_b0000_s0.jpg" in files


@pytest.mark.parametrize("flag", eval_cli.NOT_PORTED)
def test_eval_refuses_flags_not_ported(flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        eval_cli.main(["--preset", "tiny", "--synthetic", "--device", "cpu",
                       f"--{flag}", "x", "--output_dir", str(tmp_path)])
    assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_eval_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.main(["--preset", "tiny", "--synthetic", "--output_dir",
                       str(tmp_path)])


# ------------------------------------------------------------- the harness
def _frames(pt, frames):
    return [pt.Frame(f.kpts, f.track_ids, f.head_sizes, f.seq)
            for f in frames]


def _mot(pt, updates):
    acc = pt.MOTAccumulator()
    for g, p, d in updates:
        acc.update(g, p, np.asarray(d, np.float64).reshape(len(g), len(p)))
    return dict(acc.metrics, matches=acc.num_matches, miss=acc.num_miss,
                fp=acc.num_fp, gt=acc.num_gt)


nan = np.nan
MOT_CASES = {
    "counts": [([1], [9], [0.0]), ([1], [9], [0.0]), ([1], [8], [0.0]),
               ([1], [], []), ([], [8], [])],
    "carry_forward_switch": [(["g1"], ["p1"], [0.1]), (["g1"], [], []),
                             (["g1"], ["p1"], [0.2]),
                             (["g1"], ["p2"], [0.1])],
    "continuation": [(["g1", "g2"], ["p1", "p2"], [0.4, nan, 0.3, 0.45]),
                     (["g1", "g2"], ["p1", "p2"], [0.4, 0.35, 0.01, 0.45])],
    "duplicate_carried": [(["g1"], ["p1"], [0.1]), (["g2"], ["p1"], [0.1]),
                          (["g1", "g2"], ["p1"], [0.1, 0.1])],
    "miss_fp": [(["g1", "g2"], ["p1", "p9"], [0.2, nan, nan, nan])],
    "occlusion_gap": [(["g"], ["p"], [0.1]), (["g"], [], []),
                      (["g"], [], []), (["g"], ["p"], [0.1]),
                      (["g"], ["p"], [0.1])],
}


def _pt_case(name, pt, writer, tmp):
    gt2 = tp._gt_frame([(100, 100), (300, 200)], [0, 1])
    if name.startswith("mot_"):
        return _mot(pt, MOT_CASES[name[4:]])
    if name == "ap_perfect":
        gts = [gt2] * 4
        return pt.evaluate_ap(_frames(pt, gts),
                              _frames(pt, [tp._pred_from_gt(g)
                                           for g in gts]))
    if name == "ap_missed_and_fp":
        p = tp._pred_from_gt(gt2)
        far = p.kpts.copy()
        far[1, :, 0:2] += 5000
        pred = jpt.Frame(np.concatenate([p.kpts[:1], far[1:2]]),
                         np.array([0, 7]), seq="s0")
        return pt.evaluate_ap(_frames(pt, [gt2]), _frames(pt, [pred]))
    if name == "tracking_perfect":
        gts = [tp._gt_frame([(100 + 2 * t, 100), (300, 200 + t)], [0, 1])
               for t in range(5)]
        return pt.evaluate_tracking(_frames(pt, gts), _frames(
            pt, [tp._pred_from_gt(g) for g in gts]))
    if name == "tracking_id_switch":
        gts = [gt2] * 4
        preds = [tp._pred_from_gt(g, ids=[5, 6] if t < 2 else [6, 5])
                 for t, g in enumerate(gts)]
        return pt.evaluate_tracking(_frames(pt, gts), _frames(pt, preds))
    if name == "tracking_end_to_end_single_joint":
        gts = [jpt.Frame(np.array([[[0.0, 0.0, 2.0]]]), np.array([1]),
                         head_sizes=np.array([1.0]), seq="s")] * 5

        def pr(x, tid):
            return jpt.Frame(np.array([[[x, 0.0, 0.9]]]), np.array([tid]),
                             seq="s")

        empty = jpt.Frame(np.zeros((0, 1, 3)), np.zeros(0, np.int64),
                          seq="s")
        prs = [pr(0.1, 7), empty, pr(0.2, 7), pr(0.1, 8), pr(0.1, 8)]
        return pt.evaluate_tracking(_frames(pt, gts), _frames(pt, prs))
    if name == "tracking_last_frame_dropped":
        gts = [gt2] * 3
        return [pt.evaluate_tracking(_frames(pt, gts), _frames(pt, [
            tp._pred_from_gt(g, ids=([5, 6] if t < s else [6, 5]))
            for t, g in enumerate(gts)])) for s in (1, 2)]
    if name == "tracking_motp_zero":
        k_gt = np.zeros((1, 2, 3))
        k_gt[0, :, 0] = [100.0, 200.0]
        k_gt[0, :, 1] = 100.0
        k_gt[0, :, 2] = 1.0
        k_pr = k_gt.copy()
        k_pr[0, 1, 0] += 5000.0
        k_pr[0, :, 2] = 0.9
        gts = [pt.Frame(k_gt, np.array([1]), head_sizes=np.array([50.0]),
                        seq="s")] * 3
        return pt.evaluate_tracking(gts, [pt.Frame(k_pr, np.array([1]),
                                                   seq="s")] * 3)
    if name == "tracking_drops_gt_empty":
        gt = tp._gt_frame([(100, 100)], [1])
        empty = jpt.Frame(np.zeros((0, J, 3)), np.zeros(0, np.int64),
                          seq="s0")
        stray = tp._pred_from_gt(tp._gt_frame([(400, 400)], [9]))
        return pt.evaluate_tracking(
            _frames(pt, [gt, empty, gt]),
            _frames(pt, [tp._pred_from_gt(gt), stray, tp._pred_from_gt(gt)]))
    if name == "tracking_unannotated_goes_dummy":
        gt = tp._gt_frame([(100, 100)], [1])
        unannotated = jpt.Frame(np.zeros((1, J, 3)), np.array([1]),
                                head_sizes=np.array([50.0]), seq="s0")
        return pt.evaluate_tracking(_frames(pt, [gt, unannotated, gt]),
                                    _frames(pt, [tp._pred_from_gt(gt)] * 3))
    if name == "pckh_golden":
        gt = tp._gt_frame([(0, 0), (300, 300)], [1, 2])
        bad = tp._pred_from_gt(gt)
        bad.kpts[1, : J // 2, 0] += 40.0
        empty = jpt.Frame(np.zeros((0, J, 3)), np.zeros(0, np.int64),
                          seq=gt.seq)
        return [pt.evaluate_pckh(_frames(pt, [gt]), _frames(pt, [p]))
                for p in (tp._pred_from_gt(gt), bad, empty)]
    if name in ("assign_no_pred", "assign_no_gt"):
        if name == "assign_no_pred":
            kpts = np.zeros((1, J, 3))
            kpts[0, 0] = [10.0, 10.0, 1.0]
            gt = pt.Frame(kpts, np.array([4]), head_sizes=np.array([50.0]))
            pred = pt.Frame(np.zeros((0, J, 3)), np.zeros(0, np.int64))
        else:
            k = np.full((1, J, 3), np.nan)
            k[0, 2] = [5.0, 5.0, 0.9]
            pred = pt.Frame(k, np.array([1]))
            gt = pt.Frame(np.zeros((0, J, 3)), np.zeros(0, np.int64))
        scores, labels, n_gt, mot = pt.assign_frame(gt, pred)
        return dict(scores=[list(s) for s in scores],
                    labels=[[float(x) for x in lab] for lab in labels],
                    n_gt=list(n_gt),
                    mot={str(j): mot[j] for j in range(J)},
                    pckh=list(mot["pckh"]))
    if name == "voc_ap":
        return pt.voc_ap(np.array([1.0, 1.0]), np.array([1.0, 0.5]))
    if name == "posetrack18_drops_gt_empty":
        gt_dir, pred_dir = _posetrack18_fixture(tmp)
        return pt.evaluate_posetrack18(gt_dir, pred_dir)
    if name == "writer_aligns_by_traj_id":
        K, s = 15, np.full((15, 1), 0.5)

        def entry(filename, traj_ids, xs):
            kp = np.stack([np.full((K, 2), float(x)) for x in xs])
            return {"video_name": "v.json", "filename": filename,
                    "traj_ids": np.asarray(traj_ids), "pred_kpts": kp,
                    "pred_kpt_scores": np.repeat(s[None], len(xs), 0)}

        out = os.path.join(tmp, "written")
        writer.write_val_results(
            {"v.json": [entry("f0.jpg", [3, 7], [10.0, 20.0]),
                        entry("f0.jpg", [7], [40.0])]},
            {"categories": [],
             "v.json": [{"info": {"id": 0}, "filename": "f0.jpg"}]}, out)
        with open(os.path.join(out, "v.json")) as f:
            return json.load(f)
    if name == "writer_collect_results":
        rng = np.random.default_rng(4)
        results = []
        for v, ds in (("a.json", "posetrack"), ("b.json", "posetrack"),
                      ("c.json", "coco")):
            results.append({
                "dataset": ds, "video_name": v,
                "indices": (np.array([2, 0]), np.array([1, 0])),
                "inv_trans": np.array([[1.5, 0.0, 3.0], [0.0, 1.5, -2.0]]),
                "gt_traj_ids": np.array([11, 12]),
                "pred_kpts": rng.uniform(0, 90, (4, 3, J, 2)),
                "pred_kpt_scores": rng.uniform(0, 1, (4, 3, J, 1)),
                "filenames": [f"{v}_{t}.jpg" for t in range(3)]})
        by_video = writer.collect_posetrack_results(results, 2)
        return {v: [{k: (e[k] if isinstance(e[k], str)
                         else np.asarray(e[k]).tolist()) for k in e}
                    for e in entries] for v, entries in by_video.items()}
    raise KeyError(name)


def _posetrack18_fixture(tmp):
    """``test_evaluate_posetrack18_drops_gt_empty``'s two directories."""
    def kp(x, vis_or_score):
        k = np.zeros((J, 3))
        k[:, 0] = x + np.arange(J)
        k[:, 1] = 100.0
        k[:, 2] = vis_or_score
        return k.reshape(-1).tolist()

    gt = {"images": [{"id": 0}, {"id": 1}, {"id": 2}],
          "annotations": [{"image_id": i, "keypoints": kp(100, 1.0),
                           "track_id": 0, "bbox_head": [0, 0, 30, 40]}
                          for i in (0, 2)]}
    pred = {"images": [{"id": 0}, {"id": 1}, {"id": 2}],
            "annotations": [
                {"image_id": 0, "keypoints": kp(100, 0.9), "track_id": 0},
                {"image_id": 2, "keypoints": kp(100, 0.9), "track_id": 0},
                {"image_id": 1, "keypoints": kp(500, 0.9), "track_id": 5}]}
    dirs = []
    for name, data in (("gt", gt), ("pred", pred)):
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "v.json"), "w") as f:
            json.dump(data, f)
        dirs.append(d)
    return dirs


def _coco_case(name, coco, tmp):
    if name == "oks":
        k = tc._kpts(50, 50)
        gt = tc._gt_ann(0, None, bbox=(100, 100, 50, 50))
        inside = np.zeros((17, 3))
        inside[:, :2] = 120
        far = np.zeros((17, 3))
        far[:, :2] = 10000
        return [coco.compute_oks(tc._gt_ann(0, k), k),
                coco.compute_oks(gt, inside), coco.compute_oks(gt, far)]
    if name in ("golden_crowd", "crowd_removed"):
        gt_path, pr_path, _ = tc._golden_setup(
            tmp, with_crowd=name == "golden_crowd")
        return [coco.evaluate_coco_keypoints(gt_path, pr_path),
                coco.evaluate_coco_keypoints(gt_path, pr_path, max_dets=1)]
    if name in ("best_oks", "perfect", "noise"):
        rng = np.random.default_rng({"perfect": 0, "noise": 1}.get(name, 0))
        gt = {"images": [], "annotations": []}
        preds = []
        if name == "best_oks":
            gt["images"] = [{"id": 0}]
            gt["annotations"] = [tc._gt_ann(0, tc._kpts(100, 100), ann_id=1),
                                 tc._gt_ann(0, tc._kpts(108, 100), ann_id=2)]
            preds = [tc._det(0, tc._kpts(106, 100), 0.9)]
        else:
            n = 3 if name == "perfect" else 1
            for i in range(n):
                k = np.zeros((17, 3))
                k[:, 0:2] = rng.uniform(50, 400, (17, 2))
                k[:, 2] = 2
                gt["images"].append({"id": i})
                gt["annotations"].append(tc._gt_ann(i, k, ann_id=i + 1,
                                                    area=2500.0))
                if name == "noise":
                    k = k.copy()
                    k[:, 0:2] += rng.normal(0, 15, (17, 2))
                preds.append(tc._det(i, k, 0.9))
        gt_path = os.path.join(tmp, "gt.json")
        pr_path = os.path.join(tmp, "pred.json")
        with open(gt_path, "w") as f:
            json.dump(gt, f)
        with open(pr_path, "w") as f:
            json.dump(preds, f)
        return coco.evaluate_coco_keypoints(gt_path, pr_path)
    if name == "writer_schema":
        res = {7: [(np.array([0.8, 0.6]),
                    np.concatenate([np.ones((2, 15, 2)) * 50,
                                    np.ones((2, 15, 1)) * 0.9], -1))]}
        with open(coco.write_coco_results(res, tmp)) as f:
            return json.load(f)
    if name == "area_range_inclusive":
        gt = tc._gt_ann(0, tc._kpts(50, 50), area=96.0 ** 2)
        return [coco._evaluate_img([gt], [], coco.AREA_RANGES[r], 20)[3]
                for r in ("medium", "large")]
    raise KeyError(name)


PT_CASES = (["mot_" + k for k in MOT_CASES]
            + ["ap_perfect", "ap_missed_and_fp", "tracking_perfect",
               "tracking_id_switch", "tracking_end_to_end_single_joint",
               "tracking_last_frame_dropped", "tracking_motp_zero",
               "tracking_drops_gt_empty", "tracking_unannotated_goes_dummy",
               "pckh_golden", "assign_no_pred", "assign_no_gt", "voc_ap",
               "posetrack18_drops_gt_empty", "writer_aligns_by_traj_id",
               "writer_collect_results"])
COCO_CASES = ["oks", "golden_crowd", "crowd_removed", "best_oks", "perfect",
              "noise", "writer_schema", "area_range_inclusive"]


@pytest.mark.parametrize("case", [("posetrack", c) for c in PT_CASES]
                         + [("coco", c) for c in COCO_CASES],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_harness_matches_jax(case, tmp_path):
    """The port's posetrack_eval / posetrack_writer / coco_eval give JAX's
    numbers on every fixture case of the JAX tests."""
    kind, name = case
    out = {}
    for pkg, mods in (("port", (tpt, twriter, tcoco)),
                      ("jax", (jpt, jwriter, jcoco))):
        tmp = tmp_path / pkg
        tmp.mkdir()
        out[pkg] = (_pt_case(name, mods[0], mods[1], tmp)
                    if kind == "posetrack" else _coco_case(name, mods[2],
                                                           tmp))
    _assert_same(out["port"], out["jax"])


def test_lsa_pairs_is_optimal():
    """The port's scipy pairs against JAX's ``lsa_pairs``: the same cost
    (the pair order may differ), wide and tall."""
    from snipper_tpu.data.native_ops import lsa_pairs

    rng = np.random.default_rng(0)
    for shape in ((3, 5), (6, 2), (4, 4), (0, 3)):
        cost = rng.uniform(0, 1, shape)
        r, c = tpt.lsa_pairs(cost)
        rj, cj = lsa_pairs(cost)
        assert len(set(r)) == len(r) == min(shape)
        np.testing.assert_allclose(cost[r, c].sum(), cost[rj, cj].sum(),
                                   rtol=1e-12)


# ------------------------------------------------------------- the renders
def test_visualize_writes_jax_artifacts(tmp_path):
    """The 2D track overlays, heatmap and attention overlays on
    ``tests/test_visualize.py``'s fixtures: the same files as JAX's, the
    2D overlays byte for byte. (The 3D renders, the board and the GIF are
    held against JAX's through ``cli.infer --save_visuals`` in
    ``tests/test_torch_port_device_preprocess.py``.)"""
    data_dir, names = tv._fake_frames_dir(tmp_path, n=3)
    frames = tv._fake_tracks(n_frames=3)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 64, 96, 3))
    heat = [rng.uniform(0, 1, (1, 2, 8, 12, 4, 15))]
    loc = rng.uniform(0, 1, (1, 2, 6, 4, 2, 4, 2))
    attn = rng.uniform(0, 1, (1, 2, 6, 4, 2, 4))
    scores = rng.uniform(0, 1, 6)
    outs = {}
    for pkg, vis in (("port", tvis), ("jax", jvis)):
        out = str(tmp_path / pkg)
        os.makedirs(out)
        vis.save_visual_results(frames, names, data_dir, out, max_pid=2,
                                max_depth=15.0, gap=2, save_3d=False)
        vis.visualize_heatmaps(heat, images, os.path.join(out, "hm"))
        vis.visualize_heatmaps(heat, images, os.path.join(out, "hm_named"),
                               filenames=names[:2])
        vis.visualize_attention([(loc, attn)], images,
                                os.path.join(out, "attn"),
                                query_scores=scores, top_k=3)
        outs[pkg] = out
    files = _files(outs["port"])
    assert files == _files(outs["jax"])
    assert "track2d/000002_track.jpg" in files
    assert "hm/heatmap_t1.jpg" in files and "hm_named/heatmap_000001.jpg" \
        in files
    for f in files:
        if f.startswith("track2d/"):
            assert (open(os.path.join(outs["port"], f), "rb").read()
                    == open(os.path.join(outs["jax"], f), "rb").read()), f
    assert tvis.pid_palette(7) == jvis.pid_palette(7)
    pose = np.zeros((J, 4))
    pose[:, 0] = np.linspace(10, 30, J)
    pose[:, 1] = np.linspace(40, 80, J)
    pose[:, 3] = 1.0
    assert tvis.bbox_2d_padded(pose) == jvis.bbox_2d_padded(pose)


def test_eval_keypoint_renders_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    B, T, H, W = 2, 2, 48, 64
    images = rng.uniform(0, 1, (B, T, H, W, 3)).astype(np.float32)
    results = [{
        "gt_kpts": rng.uniform(5, 40, (2, T, J, 2)).astype(np.float32),
        "gt_kpts_vis": np.ones((2, T, J, 1), np.float32),
        "pred_kpts": rng.uniform(5, 40, (4, T, J, 2)).astype(np.float32),
        "pred_kpt_scores": np.ones((4, T, J, 1), np.float32),
        "indices": (np.arange(2), np.arange(2)),
    } for _ in range(B)]
    for pkg, vis in (("port", tvis), ("jax", jvis)):
        vis.save_eval_keypoint_renders(results, images, str(tmp_path / pkg),
                                       batch_idx=3)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") == ["eval_b0003_s0.jpg",
                                                 "eval_b0003_s1.jpg"]
    for f in files:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f
