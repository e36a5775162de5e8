"""Host ms per snippet of the host sub-window inside the serving loop's
decode span (``cli/infer.py::serve_snippets``, ``serve.decode``): the
group's ``decode_predictions``."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "serve")
    if tr is None or "serve.decode" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["serve.decode"] / tr["units"]
