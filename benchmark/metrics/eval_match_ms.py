"""Host ms per eval batch of the host sub-window inside the program's
matching span (``matching/matcher.py::match_layers``): the cost matrices
of every decoder layer and the assignment's launch."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "eval")
    if tr is None or "match_layers" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["match_layers"] / tr["units"]
