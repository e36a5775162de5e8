"""The port's serving export (``infer/export.py``, ``cli/export.py``) and
the MSDA kernels as registered operators, against the JAX package.

- A tiny model (two encoder layers, numpy-seeded params crossed by
  ``convert.state_dict_from_jax``) exported on the CPU in f32, saved, and
  loaded in a fresh interpreter that imports no ``snipper_tpu_torch.models``
  module (nor JAX): its outputs match JAX ``model.apply`` with the exact
  ``pmerged`` sampling within the full-model bar of
  ``tests/test_torch_parity.py`` (rtol 1e-3, atol 2e-4).
- ``cli.export --param_dtype bfloat16 --fast enc1,p2,r48`` on a trainer
  checkpoint of the same weights: the artifact holds bf16 weights only,
  widens none of them in its graph and computes in bf16 on the f32 images
  cast to bf16 (JAX's bf16 recipe), so it equals the port's live model
  under the same recipe; it returns JAX's bf16 artifact's dtypes (bf16
  predictions, f32 heatmaps) and holds within 4 bf16 units (4 * 2^-7) of
  each output's largest magnitude of JAX's bf16-parameter apply on the
  same f32 images.
- ``cli.export`` refuses m{N} after parsing, so ``mx`` gets the unknown
  profile error.
- The registered ``msda_forward``: ``torch.library.opcheck`` (schema and
  fake tensor) with a CPU implementation registered for the test, and an
  export of a module that calls it keeps one node of it; both in a fresh
  interpreter, so that the test's CPU kernel goes with it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.infer import fast as jfast
from snipper_tpu.models import snipper as jsnipper
from snipper_tpu_torch.cli import export as export_cli
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.infer import export as texport
from test_torch_port_model import TINY, close, flax_params, japply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = "enc1,p2,r48"
BF16_UNITS = 4 * 2.0 ** -7

_LOADER = r"""
import json, sys
import numpy as np
from snipper_tpu_torch.infer.export import load_exported

inputs = np.load(sys.argv[1])
outs = {}
for name in ("f32",):
    run = load_exported(sys.argv[2] + "/" + name + ".pt2")
    out = run(inputs[name])
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        outs[name + "/" + k] = out[k].numpy()
    for i, h in enumerate(out["heatmaps"]):
        outs[name + "/heatmaps" + str(i)] = h.numpy()
    outs[name + "/sampling_overflow"] = out["sampling_overflow"].numpy()
    outs[name + "/dtype"] = np.array(str(out["pred_logits"].dtype))
    outs[name + "/keys"] = np.array(sorted(out))
np.savez(sys.argv[2] + "/outputs.npz", **outs)
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith(("snipper_tpu", "jax")))))
"""


def _run(code, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _bf16(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16)
        if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Two artifacts of one seeded tiny enc2 model: ``f32`` from
    ``export_forward``, loaded and run in a fresh interpreter, and ``bf16``
    from ``cli.export --param_dtype bfloat16 --fast enc1,p2,r48``."""
    tmp = str(tmp_path_factory.mktemp("export"))
    kw = dict(TINY, enc_layers=2)
    jcfg = JaxConfig(**kw)
    x0 = jnp.zeros((1, jcfg.num_frames, jcfg.input_height,
                    jcfg.input_width, 3), jnp.float32)
    params = flax_params(jsnipper.build_model(jcfg), x0, seed=11)
    state = state_dict_from_jax(params)
    ep = texport.export_forward(Config(**kw), state, device="cpu")
    f32_bytes = texport.save_exported(ep, os.path.join(tmp, "f32.pt2"))
    ckpt = os.path.join(tmp, "ckpt.pt")
    torch.save({"params": state, "step": 0}, ckpt)
    res = export_cli.main([
        "--preset", "tiny", "--enc_layers", "2", "--resume", ckpt,
        "--fast", FAST, "--param_dtype", "bfloat16", "--output",
        os.path.join(tmp, "bf16.pt2"), "--device", "cpu"])
    rng = np.random.default_rng(12)
    jfcfg, jtransform = jfast.fast_profiles(jcfg, FAST)
    inputs = {}
    for name, c in (("f32", jcfg), ("bf16", jfcfg)):
        inputs[name] = rng.uniform(0, 1, (1, c.num_frames, c.input_height,
                                          c.input_width, 3)
                                   ).astype(np.float32)
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    modules = _run(_LOADER, os.path.join(tmp, "inputs.npz"), tmp)
    got = dict(np.load(os.path.join(tmp, "outputs.npz")))
    return dict(params=params, state=state, jcfg=jcfg, jfcfg=jfcfg,
                jtransform=jtransform, inputs=inputs, got=got,
                modules=modules, cli=res, f32_bytes=f32_bytes)


def test_loader_imports_no_model_code(artifacts):
    mods = artifacts["modules"]
    assert "snipper_tpu_torch.ops.msda" in mods
    assert not [m for m in mods if m.startswith(
        ("snipper_tpu_torch.models", "snipper_tpu.", "jax"))
        or m == "snipper_tpu"], mods


# the outputs JAX's artifact leaves out (snipper_tpu/infer/export.py:53-56)
JAX_DROP = {"aux_logits", "aux_kpts2d", "aux_depth", "init_reference",
            "references", "attn_data"}


def test_f32_artifact_matches_jax_apply(artifacts):
    """JAX's apply within the parity bar, with JAX's artifact's keys: the
    model's without the aux heads, the references and the attention
    data."""
    jcfg = artifacts["jcfg"].replace(deform_impl="pmerged")
    want = japply(jsnipper.build_model(jcfg), artifacts["params"],
                  jnp.asarray(artifacts["inputs"]["f32"]))
    got = artifacts["got"]
    assert sorted(set(want) - JAX_DROP) == got["f32/keys"].tolist()
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        close(torch.from_numpy(got["f32/" + k]), want[k])
    assert len(want["heatmaps"]) == 3
    for i, w in enumerate(want["heatmaps"]):
        close(torch.from_numpy(got[f"f32/heatmaps{i}"]), w)
    assert got["f32/sampling_overflow"].dtype == np.int32
    assert got["f32/sampling_overflow"].shape == ()
    assert int(got["f32/sampling_overflow"]) == 0


def test_bf16_artifact_matches_jax(artifacts, tmp_path):
    """The bf16 artifact on f32 images: the port's live model under JAX's
    bf16 recipe (``bf16_model``, the images cast to bf16) bit for bit,
    with JAX's bf16 artifact's output dtypes; JAX's bf16-parameter apply
    on the same f32 images within 4 bf16 units of each output's scale
    (on the CPU: 1.87 / 1.96 / 1.28 on the predictions, 3.22 / 2.21 /
    2.84 on the heatmaps). JAX promotes its backbone and encoder to f32
    there (an f32 image against bf16 weights) where the port computes in
    bf16; a bf16 forward cannot be held closer in any case: JAX's own
    jitted and op-by-op bf16 forwards differ by up to 1.91 units at the
    tiny fixture of tests/test_torch_port_bench.py."""
    from snipper_tpu_torch.infer.fast import fast_profiles
    from snipper_tpu_torch.models.snipper import bf16_model, build_model

    run = texport.load_exported(artifacts["cli"]["path"])
    x = artifacts["inputs"]["bf16"]
    got = run(x)
    cfg, transform = fast_profiles(Config.tiny().replace(enc_layers=2), FAST)
    live = build_model(cfg, device="cpu")
    live.load_state_dict(transform(artifacts["state"]))
    bf16_model(live)
    with torch.inference_mode():
        want_live = live(torch.from_numpy(x).to(torch.bfloat16))
    jfcfg = artifacts["jfcfg"].replace(deform_impl="pmerged")
    pb = _bf16(artifacts["jtransform"](artifacts["params"]))
    jax_bf16 = japply(jsnipper.build_model(jfcfg), pb, jnp.asarray(x))
    pairs = [(k, got[k], want_live[k], jax_bf16[k])
             for k in ("pred_logits", "pred_kpts2d", "pred_depth")]
    pairs += [(f"heatmaps{i}", g, lv.float(), w) for i, (g, lv, w) in
              enumerate(zip(got["heatmaps"], want_live["heatmaps"],
                            jax_bf16["heatmaps"]))]
    for k, g, lv, w in pairs:
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
        torch.testing.assert_close(g, lv, rtol=0, atol=0)
        w = np.asarray(w, np.float32)
        tol = BF16_UNITS * max(1.0, np.abs(w).max())
        assert np.abs(g.float().numpy() - w).max() <= tol, k


def test_bf16_artifact_holds_no_f32_weight(artifacts):
    """The bf16 artifact's program: every weight it holds is bf16, and no
    node of its graph converts a weight to another dtype."""
    ep = texport.load_exported(artifacts["cli"]["path"]).exported
    floats = [t for t in ep.state_dict.values() if t.is_floating_point()]
    assert floats and all(t.dtype == torch.bfloat16 for t in floats)
    sig = ep.graph_signature
    weights = {*sig.inputs_to_parameters, *sig.inputs_to_buffers}
    casts = ("_to_copy", "convert_element_type", "to.dtype", "copy")
    converted = [n.name for n in ep.graph.nodes if n.op == "call_function"
                 and any(c in str(n.target) for c in casts)
                 and any(getattr(a, "name", None) in weights
                         for a in n.args)]
    assert len(weights) > 100 and not converted, converted


def test_bf16_artifact_is_about_half(artifacts):
    assert artifacts["cli"]["bytes"] < 0.6 * artifacts["f32_bytes"]
    assert artifacts["cli"]["device"] == "cpu"


@pytest.mark.parametrize("spec,err", [
    ("m2", "m{N} is refused"), ("enc1,m3", "m{N} is refused"),
    ("mx", "unknown profile 'mx'"), ("p3,p2", "given twice")])
def test_cli_export_refuses(spec, err, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        export_cli.main(["--preset", "tiny", "--enc_layers", "2", "--fast",
                         spec, "--output", str(tmp_path / "a.pt2"),
                         "--device", "cpu"])
    assert e.value.code == 2
    assert err in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "a.pt2")


@pytest.mark.parametrize("platforms,want", [
    (None, "cuda"), (["gpu"], "cuda"), (["cpu"], "cpu"), (["CUDA"], "cuda")])
def test_resolve_platform(platforms, want):
    assert texport.resolve_platform(platforms) == want


@pytest.mark.parametrize("platforms", [["tpu"], ["cpu", "cuda"]])
def test_resolve_platform_refuses(platforms):
    with pytest.raises(ValueError):
        texport.resolve_platform(platforms)


def test_export_docstrings_quote_no_tpu_figure():
    """JAX's export notes a TPU v5e timing; the port's say nothing of a
    TPU's speed."""
    text = (texport.__doc__ or "") + (export_cli.__doc__ or "") + \
        (texport.load_exported.__doc__ or "")
    for word in ("v5e", "6x", "slower"):
        assert word not in text, word


_OPCHECK = r"""
import json
import torch
from snipper_tpu_torch.ops import msda

# a CPU implementation for this test only: the plain version, below
# autograd
@msda._msda_forward_op.register_kernel("cpu")
def _(value, shapes, loc, attn):
    return msda.ms_deform_attn_torch(value, msda._pairs(shapes), loc, attn)

g = torch.Generator().manual_seed(0)
shapes = [(6, 9), (3, 5)]
S = sum(h * w for h, w in shapes)
res = {}
for dt in (torch.float32, torch.bfloat16):
    value = torch.randn(2, S, 4, 8, generator=g).to(dt)
    loc = torch.rand(2, 7, 4, 2, 3, 2, generator=g)
    attn = torch.rand(2, 7, 4, 2, 3, generator=g)
    args = (value, msda.flat_shapes(shapes), loc, attn)
    res[str(dt)] = torch.library.opcheck(
        torch.ops.snipper_tpu_torch.msda_forward.default, args,
        test_utils=("test_schema", "test_faketensor"))

class Sample(torch.nn.Module):
    def forward(self, value, loc, attn):
        return torch.ops.snipper_tpu_torch.msda_forward(
            value, msda.flat_shapes(shapes), loc, attn) * 2.0

ep = torch.export.export(Sample(), (value.float(), loc, attn))
res["nodes"] = [str(n.target) for n in ep.graph.nodes
                if n.op == "call_function"]
res["export_matches"] = bool(torch.equal(
    ep.module()(value.float(), loc, attn),
    2.0 * msda.ms_deform_attn_torch(value.float(), shapes, loc, attn)))
print(json.dumps(res))
"""


def test_registered_forward_op_opcheck_and_export():
    res = _run(_OPCHECK)
    for dt in ("torch.float32", "torch.bfloat16"):
        assert res[dt] == {"test_schema": "SUCCESS",
                           "test_faketensor": "SUCCESS"}, res[dt]
    assert res["nodes"].count("snipper_tpu_torch.msda_forward.default") == 1
    assert res["export_matches"]


def test_registered_ops_schemas_and_fakes():
    """The backward op's fake gives the kernels' gradients in the inputs'
    shapes, d_value in the value's dtype and d_loc, d_attn in f32, for
    either value dtype; neither op has a CPU kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from snipper_tpu_torch.ops import msda

    assert str(torch.ops.snipper_tpu_torch.msda_forward.default._schema) \
        == ("snipper_tpu_torch::msda_forward(Tensor value, SymInt[] shapes,"
            " Tensor loc, Tensor attn) -> Tensor")
    shapes = [6, 9, 3, 5]
    for dt in (torch.float32, torch.bfloat16):
        with FakeTensorMode():
            value = torch.empty(2, 69, 4, 8, dtype=dt)
            loc = torch.empty(2, 7, 4, 2, 3, 2)
            attn = torch.empty(2, 7, 4, 2, 3)
            out = torch.ops.snipper_tpu_torch.msda_forward(value, shapes,
                                                           loc, attn)
            grads = torch.ops.snipper_tpu_torch.msda_backward(
                value, shapes, loc, attn, torch.empty(2, 7, 32, dtype=dt))
        assert tuple(out.shape) == (2, 7, 32) and out.dtype == dt
        assert [tuple(t.shape) for t in grads] == [
            (2, 69, 4, 8), (2, 7, 4, 2, 3, 2), (2, 7, 4, 2, 3)]
        assert [t.dtype for t in grads] == [dt, torch.float32,
                                            torch.float32]
    with pytest.raises(ValueError, match="CUDA"):
        msda.msda_forward(torch.zeros(1, 4, 1, 2), [(2, 2)],
                          torch.zeros(1, 3, 1, 1, 1, 2),
                          torch.zeros(1, 3, 1, 1, 1))
    with pytest.raises(NotImplementedError):
        torch.ops.snipper_tpu_torch.msda_backward(
            torch.zeros(1, 4, 1, 2), [2, 2], torch.zeros(1, 3, 1, 1, 1, 2),
            torch.zeros(1, 3, 1, 1, 1), torch.zeros(1, 3, 2))


def test_probe_serve_lines(capsys, monkeypatch):
    """``probe serve`` on tiny on the CPU: bf16 weights and an f32 input,
    as JAX's ``serve`` (which has no ``--param_dtype``); the live forward
    and the loaded artifact in ms per snippet and as a ratio, the
    artifact's size, the dtype on each line; the header quotes no TPU
    figure. The timer is a stand-in (a CPU time says nothing of the
    card). The artifact's outputs are held to JAX's within 4 bf16 units
    in test_bf16_artifact_matches_jax (JAX's own jitted and op-by-op bf16
    forwards differ by up to 1.91)."""
    from snipper_tpu_torch.scripts import probe

    monkeypatch.setattr(probe, "time_fn", lambda fn, x, **kw: (fn(x), 2.0)[1])
    assert probe.main(["serve", "--preset", "tiny", "--device", "cpu",
                       "-K", "1"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == ("serving artifact probe on cpu: tiny, bfloat16 "
                        "weights, f32 input, batch 1")
    assert lines[1].startswith("artifact: ") and "MB (bfloat16 weights)" \
        in lines[1]
    assert lines[2].startswith("live forward (ms_deform_attn_torch, "
                               "bfloat16): ")
    assert lines[3].startswith("artifact (load_exported, bfloat16): ")
    assert lines[2].endswith(":    2.00 ms/snippet")
    assert lines[3].endswith("(1.000x live)") and lines[-1] == "DONE"
    assert "TPU" not in out and "v5e" not in out
