"""Host ms per eval batch of the host sub-window inside the eval loop's
readback span (``train/engine.py::evaluate``, ``eval.readback``): the
read of the losses and of the outputs to the host, which waits for the
step to end on the card."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "eval")
    if tr is None or "eval.readback" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["eval.readback"] / tr["units"]
