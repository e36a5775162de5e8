"""Deformable-attention sampling: the plain PyTorch version and the Hopper
kernels ``msda_forward`` and ``msda_backward`` behind one differentiable
wrapper that chooses by device."""
