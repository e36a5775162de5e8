"""Preemption-safe checkpointing: the port's own copy of
``snipper_tpu/train/preemption.py``.

The reference has no failure handling: training aborts on non-finite loss
and recovery is a manual ``--resume`` (reference ``engine.py:68-71``,
``main.py:242-248``). Here SIGTERM/SIGINT end the epoch early, its
checkpoint is written, and ``--resume auto`` picks it up."""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Registers SIGTERM/SIGINT handlers that set a flag; the training loop
    checks ``should_stop`` each step and writes a final checkpoint.

    Usage:
        guard = PreemptionGuard()
        for step in ...:
            ...
            if guard.should_stop:
                save_checkpoint(...); break
    """

    def __init__(self):
        self.should_stop = False
        self._sigint_seen = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):  # non-main thread etc.
                pass

    def _handle(self, signum, frame):
        if signum == signal.SIGINT:
            if self._sigint_seen:
                # SECOND Ctrl-C: the flag is only polled between steps, and
                # a step that hangs never reaches the poll — escalate so
                # the user can actually interrupt.
                # (Keyed on a prior SIGINT, not on should_stop: a single
                # Ctrl-C after a SIGTERM preemption must NOT abort the
                # preemption checkpoint save.)
                signal.signal(signal.SIGINT,
                              self._prev.get(signal.SIGINT, signal.SIG_DFL))
                raise KeyboardInterrupt
            self._sigint_seen = True
        self.should_stop = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
