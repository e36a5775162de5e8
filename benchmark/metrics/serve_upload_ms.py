"""Host ms per snippet of the host sub-window inside the serving loop's
upload span (``cli/infer.py::serve_snippets``, ``serve.upload``): the
copy of the warped frames to the card (on the device path: the copies and
the warp)."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "serve")
    if tr is None or "serve.upload" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["serve.upload"] / tr["units"]
