"""Counted forward and backward operations per step times the untraced steps per second, over the bf16 peak."""

from benchmark.metrics import _common


def read(run):
    return _common.mfu(run, "train")
