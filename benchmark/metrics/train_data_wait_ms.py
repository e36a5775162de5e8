"""Mean ms a training step waits for its batch (the program's data_seconds: the loader and the next batch's copy), over the window's untraced steps."""

from benchmark.metrics import _common


def read(run):
    return _common.mean(run, "data_wait_ms", "train")
