"""snipper_tpu_torch: the PyTorch/CUDA port of snipper_tpu for NVIDIA
Hopper GPUs.

It mirrors ``snipper_tpu``'s module layout and names and imports nothing of
it (nor JAX):

- ``snipper_tpu_torch.ops``    -- deformable-attention sampling: the plain
                                  PyTorch version and the hand-written CUDA
                                  kernels ``msda_forward``, ``msda_backward``
- ``snipper_tpu_torch.models`` -- ResNet backbone, 3D sine position
                                  encoding, temporal deformable transformer,
                                  Snipper model
- ``snipper_tpu_torch.convert`` -- JAX params / original-repo checkpoints ->
                                  the port's state dict
- ``snipper_tpu_torch.infer``  -- snippet sampling, decoding, association,
                                  serving profiles, the exported artifact
- ``snipper_tpu_torch.data``, ``.matching``, ``.losses``, ``.train``,
  ``.eval``, ``.utils``        -- the training slice: synthetic data and
                                  loader, Hungarian matching, criterion,
                                  optimizer and steps, metrics, logging
- ``snipper_tpu_torch.cli``    -- ``python -m snipper_tpu_torch.cli.infer``,
                                  ``.cli.train``, ``.cli.eval``,
                                  ``.cli.export``, ``.cli.dump_labels``

Entry points run on the GPU unless the CPU is asked for.
"""

__version__ = "0.1.0"
