"""The sampling forward kernel's share of its roofline in the traced snippets: the counted least time of every sampling call of a snippet's forward over msda_forward's device time."""

from benchmark.metrics import _common


def read(run):
    return _common.sampling_roofline(run, "serve", "msda_forward", False)
