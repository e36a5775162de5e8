"""Host ms per eval batch of the host sub-window inside the eval loop's
step span (``train/engine.py::evaluate``, ``eval.step``: the forward and
the criterion) less the matching span nested in it (``match_layers``): on
a card, the time to queue the forward's and the losses' kernels."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "eval")
    if tr is None or "eval.step" not in tr["spans"]:
        return None
    step = tr["spans"]["eval.step"] - tr["spans"].get("match_layers", 0.0)
    return 1e3 * step / tr["units"]
