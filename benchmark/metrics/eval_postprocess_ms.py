"""Host ms per eval batch of the host sub-window inside the eval loop's
postprocess span (``train/engine.py::evaluate``, ``eval.postprocess``)."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "eval")
    if tr is None or "eval.postprocess" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["eval.postprocess"] / tr["units"]
