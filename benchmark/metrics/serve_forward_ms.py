"""Mean ms of the serving loop's forward per snippet: upload, the device warp where it runs, the forward and the readback (the program's forward_ms), over the window's untraced snippets."""

from benchmark.metrics import _common


def read(run):
    return _common.mean(run, "forward_ms", "serve")
