"""Probe scripts of the port: ``python -m snipper_tpu_torch.scripts.probe``
(the sampling-op sweep and the lane-gather probe)."""
