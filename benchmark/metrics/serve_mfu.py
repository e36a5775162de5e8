"""Counted forward operations per snippet times the untraced snippets per second, over the f32 peak (TF32 off)."""

from benchmark.metrics import _common


def read(run):
    return _common.mfu(run, "serve")
