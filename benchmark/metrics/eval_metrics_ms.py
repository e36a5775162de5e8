"""Host ms per eval batch of the host sub-window inside the eval loop's
metrics span (``train/engine.py::evaluate``, ``eval.metrics``): the
renders when asked, PCKh and the 3D metrics of the batch."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "eval")
    if tr is None or "eval.metrics" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["eval.metrics"] / tr["units"]
