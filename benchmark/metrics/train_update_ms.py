"""Host ms per training step of the host sub-window inside the program's
update span (``train/step.py::train_step``'s ``train.update``, a
``record_function``): the clip and the AdamW update's launches."""

from benchmark.metrics import _common


def read(run):
    tr = _common.traced_host(run, "train")
    if tr is None or "train.update" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["train.update"] / tr["units"]
