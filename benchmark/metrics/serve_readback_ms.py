"""Host ms per snippet of the host sub-window inside the serving loop's
readback span (``cli/infer.py::serve_snippets``, ``serve.readback``): the
three reads of the outputs to the host, which wait for the forward to
end on the card."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "serve")
    if tr is None or "serve.readback" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["serve.readback"] / tr["units"]
