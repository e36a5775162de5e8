"""The sampling backward kernel's share of its roofline in the traced steps: the counted least time of every sampling call's backward over msda_backward's device time."""

from benchmark.metrics import _common


def read(run):
    return _common.sampling_roofline(run, "train", "msda_backward", True)
