"""Nothing the benchmark loads is JAX, flax or the JAX package, and the
plain reference loads nothing of the program under test. Top-level names
are compared whole: ``snipper_tpu_torch`` is not ``snipper_tpu``."""

import ast
import json
import subprocess
import sys

from benchmark import harness
from conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.harness as h
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_modules(body):
    p = subprocess.run([sys.executable, "-c",
                        PROBE.format(root=str(ROOT), body=body)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    body = "\n".join(
        ["import snipper_tpu_torch.cli.infer, snipper_tpu_torch.train.engine",
         "import snipper_tpu_torch.train.state, snipper_tpu_torch.data.loader",
         "for k in ('serve', 'train', 'eval'): h.driver(k)",
         "for m in h.manifest()['per_layer']: h.metric_reader(m['name'])"])
    tops = _top_modules(body)
    assert not tops & set(harness.FORBIDDEN)
    assert "snipper_tpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    body = ("import benchmark.reference.model, benchmark.reference.train, "
            "benchmark.reference.criterion, benchmark.reference.postprocess")
    tops = _top_modules(body)
    assert not tops & (set(harness.FORBIDDEN) | {"snipper_tpu_torch"})
    for path in (harness.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [
                    getattr(node, "module", None) or ""]
                assert not any(n.split(".")[0].startswith("snipper")
                               or n.split(".")[0] in harness.FORBIDDEN
                               for n in names), (path, names)
