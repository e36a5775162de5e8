"""Deformable-attention sampling: the plain PyTorch version and the Hopper
kernel ``msda_forward`` behind one wrapper that chooses by device."""
