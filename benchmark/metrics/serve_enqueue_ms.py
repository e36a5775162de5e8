"""Host ms per snippet of the host sub-window inside the serving loop's
model call (``cli/infer.py::serve_snippets``): on a card, the time to
queue the forward's kernels. Read as the forward's four stages
(``models/snipper.py``: ``model.backbone``, ``model.encoder``,
``model.decoder``, ``model.heads``), which cover the call between them:
the loop opens no span of its own around the call, since the
benchmark's forward callable starts and stops the traced sub-windows
inside it."""

from benchmark.metrics import _common

STAGES = ("model.backbone", "model.encoder", "model.decoder", "model.heads")


def read(run):
    tr = _common.traced_host(run, "serve")
    if tr is None or not all(s in tr["spans"] for s in STAGES):
        return None
    return 1e3 * sum(tr["spans"][s] for s in STAGES) / tr["units"]
