"""Mean ms a snippet waits for its decoded (host path: and warped) frames from the serving loop's prefetch thread (the program's wait_ms), over the window's untraced snippets."""

from benchmark.metrics import _common


def read(run):
    return _common.mean(run, "wait_ms", "serve")
