"""Multi-GPU: the rank mesh (data and model axes), the tensor-parallel
cuts, process groups and object gathers over ``torch.distributed``."""

from snipper_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
)
