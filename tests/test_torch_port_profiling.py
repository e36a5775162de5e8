"""The port's trace summarizer (``utils/profiling.py``) against the JAX
package's, and the profiled training window of ``cli.train``.

- JAX's seven ``tests/test_profiling.py`` cases, rewritten for the Chrome
  trace that ``torch.profiler`` writes: device events (``cat`` kernel,
  gpu_memcpy, gpu_memset) by self time per (pid, tid) lane; host
  annotations, runtime calls and other lanes ignored; ``cpu_op`` events
  when the trace has no device lane.
- The same abstract events, written in JAX's trace format and in torch's,
  give equal summaries from the two ``summarize_trace``.
- A real ``torch.profiler`` trace of a tiny CPU forward gives a non-empty
  summary of its operators.
- ``cli.train --profile_dir`` on tiny on the CPU writes the trace, prints
  the summary and, in a short epoch, JAX's clamp line.
"""

import gzip
import json
import os

import torch

from snipper_tpu.utils.profiling import summarize_trace as jax_summarize
from snipper_tpu_torch.utils.profiling import summarize_trace, trace


def _write(tmp_path, events, name="trace_1.pt.trace.json"):
    with open(tmp_path / name, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _kernel(ts, dur, name, tid=7, pid=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "name": name}


def _meta(pid, name):
    return {"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}


def test_self_time_subtracts_direct_children(tmp_path):
    evs = [
        _meta(0, "python3"),
        # parent 10 ms with one nested child of 4 ms -> self 6 ms
        _kernel(0, 10_000, "a"),
        _kernel(2_000, 4_000, "b"),
        # disjoint sibling 3 ms
        _kernel(20_000, 3_000, "a"),
    ]
    top = summarize_trace(_write(tmp_path, evs))
    assert abs(top["a"] - 9.0) < 1e-9   # 6 self + 3 sibling
    assert abs(top["b"] - 4.0) < 1e-9
    # self times sum exactly to the lane's busy time (no double counting)
    assert abs(sum(top.values()) - 13.0) < 1e-9


def test_host_events_and_annotations_are_ignored(tmp_path):
    evs = [
        _meta(0, "python3"),
        # the step annotation on the device lane and on the host
        _kernel(0, 50_000, "ProfilerStep#2", cat="gpu_user_annotation"),
        _kernel(0, 50_000, "ProfilerStep#2", tid=1, pid=701,
                cat="user_annotation"),
        _kernel(0, 5_000, "conv"),
        # host operators and runtime calls do not appear either
        _kernel(0, 7_000, "aten::conv2d", tid=1, pid=701, cat="cpu_op"),
        _kernel(0, 7_000, "cudaLaunchKernel", tid=1, pid=701,
                cat="cuda_runtime"),
        _kernel(60_000, 1_000, "Memcpy HtoD", cat="gpu_memcpy"),
        _kernel(70_000, 500, "Memset", cat="gpu_memset"),
    ]
    top = summarize_trace(_write(tmp_path, evs))
    assert top == {"conv": 5.0, "Memcpy HtoD": 1.0, "Memset": 0.5}


def test_concurrent_lanes_do_not_nest_across_lanes(tmp_path):
    # two streams: a 10 ms kernel on one overlapping a 6 ms kernel on the
    # other are concurrent, not parent and child: 16 ms, not 10 - 6
    evs = [_kernel(0, 10_000, "a", tid=7), _kernel(1_000, 6_000, "b", tid=8)]
    top = summarize_trace(_write(tmp_path, evs))
    assert abs(top["a"] - 10.0) < 1e-9
    assert abs(top["b"] - 6.0) < 1e-9


def test_metadata_without_args_does_not_crash(tmp_path):
    evs = [{"ph": "M", "pid": 0, "tid": 9, "name": "thread_name"},
           {"ph": "M", "pid": 0, "name": "process_name"},
           _kernel(0, 2_000, "conv")]
    assert summarize_trace(_write(tmp_path, evs)) == {"conv": 2.0}


def test_cpu_trace_falls_back_to_cpu_ops(tmp_path):
    # a CPU run: no device lane; the host operators by self time
    evs = [_kernel(0, 3_000, "aten::linear", tid=1, pid=701, cat="cpu_op"),
           _kernel(500, 2_000, "aten::addmm", tid=1, pid=701, cat="cpu_op"),
           _kernel(0, 9_000, "model_forward", tid=1, pid=701,
                   cat="python_function")]
    top = summarize_trace(_write(tmp_path, evs))
    assert top == {"aten::addmm": 2.0, "aten::linear": 1.0}


def test_n_iters_divides_and_top_k_truncates(tmp_path):
    evs = [_kernel(i * 10_000, (i + 1) * 1_000, f"k{i}") for i in range(5)]
    top = summarize_trace(_write(tmp_path, evs), top_k=2, n_iters=2)
    assert list(top) == ["k4", "k3"]
    assert abs(top["k4"] - 2.5) < 1e-9


def test_empty_dir_returns_empty(tmp_path):
    assert summarize_trace(str(tmp_path)) == {}


def test_newest_trace_is_read_gzip_too(tmp_path):
    _write(tmp_path, [_kernel(0, 1_000, "old")], "trace_1.pt.trace.json")
    os.utime(tmp_path / "trace_1.pt.trace.json", (1, 1))
    with gzip.open(tmp_path / "trace_2.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": [_kernel(0, 2_000, "new")]}, f)
    assert summarize_trace(str(tmp_path)) == {"new": 2.0}


# (lane, ts us, dur us, name): two lanes, nesting, siblings
ABSTRACT = [(0, 0, 10_000, "fusion"), (0, 2_000, 4_000, "dot"),
            (0, 3_000, 1_000, "add"), (0, 20_000, 3_000, "fusion"),
            (1, 1_000, 6_000, "dot"), (1, 8_000, 2_000, "copy")]


def _jax_trace(tmp_path, events):
    d = tmp_path / "jax" / "plugins" / "profile" / "2026_01_01_00_00_00"
    os.makedirs(d)
    evs = [{"ph": "M", "pid": 3, "name": "process_name",
            "args": {"name": "/device:GPU:0"}}]
    for lane in {e[0] for e in events}:
        evs.append({"ph": "M", "pid": 3, "tid": 10 + lane,
                    "name": "thread_name", "args": {"name": "XLA Ops"}})
    for lane, ts, dur, name in events:
        evs.append({"ph": "X", "pid": 3, "tid": 10 + lane, "ts": ts,
                    "dur": dur, "name": name + ".1",
                    "args": {"source": name}})
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": evs}, f)
    return str(tmp_path / "jax")


def test_same_events_give_jax_summary(tmp_path):
    jax_dir = _jax_trace(tmp_path, ABSTRACT)
    os.makedirs(tmp_path / "torch")
    torch_dir = _write(tmp_path / "torch",
                       [_kernel(ts, dur, name, tid=20 + lane)
                        for lane, ts, dur, name in ABSTRACT])
    for top_k, n_iters in ((15, 1), (2, 3)):
        want = jax_summarize(jax_dir, top_k=top_k, n_iters=n_iters)
        got = summarize_trace(torch_dir, top_k=top_k, n_iters=n_iters)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) < 1e-9, k


def test_real_cpu_trace_summarizes(tmp_path):
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.models.snipper import build_model

    cfg = Config.tiny()
    model = build_model(cfg, device="cpu")
    x = torch.rand(1, cfg.num_frames, cfg.input_height, cfg.input_width, 3)
    with trace(str(tmp_path)), torch.inference_mode():
        model(x)
    top = summarize_trace(str(tmp_path), top_k=5)
    assert len(top) == 5 and all(v > 0 for v in top.values())
    assert all(k.startswith("aten::") for k in top)


def test_train_cli_profile_dir(tmp_path, capsys):
    from snipper_tpu_torch.cli import train as train_cli

    prof = tmp_path / "prof"
    res = train_cli.main([
        "--preset", "tiny", "--synthetic", "--synthetic_samples", "4",
        "--num_workers", "0", "--device", "cpu", "--epochs", "1",
        "--steps_per_epoch", "3", "--eval_every", "5", "--output_dir",
        str(tmp_path / "out"), "--profile_dir", str(prof),
        "--profile_steps", "2"])
    assert len(res["history"]) == 3
    out = capsys.readouterr().out
    # 3 steps < 2 + 2: JAX's clamp, the window starts at step 1
    assert ("profile window clamped to start at step 1 (short epoch — the "
            "trace may include compile/warm steps)") in out
    assert f"profile trace written to {prof}" in out
    lines = [ln for ln in out.splitlines() if " ms/step  aten::" in ln]
    assert len(lines) == 10
    # the matching's host time, apart
    assert [ln for ln in out.splitlines()
            if ln.endswith(" ms/step  host span match_layers")]
    assert len(os.listdir(prof)) == 1
    assert summarize_trace(str(prof))


def test_train_cli_profile_window_starts_at_step_2(tmp_path, capsys,
                                                    monkeypatch):
    """A long enough epoch opens the window at step 2, unclamped (the
    trace itself is a stand-in here; test_train_cli_profile_dir takes a
    real one)."""
    import contextlib

    from snipper_tpu_torch.cli import train as train_cli
    from snipper_tpu_torch.train import engine
    from snipper_tpu_torch.utils import profiling

    steps, started = [], []

    @contextlib.contextmanager
    def spy(log_dir):
        started.append(len(steps))
        yield

    step = engine.train_step
    monkeypatch.setattr(profiling, "trace", spy)
    monkeypatch.setattr(engine, "train_step",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    train_cli.main([
        "--preset", "tiny", "--synthetic", "--synthetic_samples", "4",
        "--num_workers", "0", "--device", "cpu", "--epochs", "1",
        "--steps_per_epoch", "4", "--eval_every", "5", "--output_dir",
        str(tmp_path / "out"), "--profile_dir", str(tmp_path / "p"),
        "--profile_steps", "2"])
    assert started == [2] and len(steps) == 4
    assert "clamped" not in capsys.readouterr().out


def test_host_spans_sum_annotations(tmp_path):
    from snipper_tpu_torch.utils.profiling import host_spans

    evs = [_kernel(0, 4_000, "match_layers", tid=1, pid=701,
                   cat="user_annotation"),
           _kernel(9_000, 2_000, "match_layers", tid=1, pid=701,
                   cat="user_annotation"),
           _kernel(0, 50_000, "ProfilerStep#2", tid=1, pid=701,
                   cat="user_annotation"),
           _kernel(0, 3_000, "match_layers", cat="gpu_user_annotation"),
           _kernel(0, 1_000, "k")]
    assert host_spans(_write(tmp_path, evs), n_iters=2) == {
        "match_layers": 3.0}
