"""The datasets' host warp: the port's own copy of ``warp_patch`` from
``snipper_tpu/data/native_ops.py:47-69``.

The JAX package runs it in its C++ extension (``native/imageops.cpp``)
when that is built and in numpy otherwise; the port has no host C++
extension and always takes the numpy path, which the JAX package holds
its C++ op to within 1e-5. The module's other op, the assignment
``lsa_pairs`` of the eval harness, lives in ``eval/posetrack_eval.py``
(scipy).
"""

from __future__ import annotations

import numpy as np

from snipper_tpu_torch.data.transforms import generate_patch_image


def warp_patch(img: np.ndarray, trans: np.ndarray, out_shape,
               do_flip: bool = False,
               color_scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Fused flip + bilinear warp + /255 + per-channel color scale + clip.
    ``img`` uint8 [H, W, 3]; returns float32 [out_h, out_w, 3]."""
    patch = generate_patch_image(img, do_flip, trans, out_shape)
    for c in range(3):
        patch[:, :, c] = np.clip(patch[:, :, c] * color_scale[c], 0, 1)
    return patch.astype(np.float32)
