"""Share of the traced run's device sub-window (eval units, CUDA activity only) in which no kernel, copy or memset ran on the device: 1 - busy / window, from the trace alone."""

from benchmark.metrics import _common


def read(run):
    return _common.idle_share(run, "eval")
