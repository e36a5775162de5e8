"""JOINT15 skeleton constants the training path needs: the port's own copy
of the relevant part of ``snipper_tpu/data/skeleton.py``.

The common 15-joint set (reference ``datasets/hybrid_dataloader.py:15-44``):
['root'(=pelvis midpoint), 'nose/head_top', 'neck', 'left_shoulder',
 'right_shoulder', 'left_elbow', 'right_elbow', 'left_wrist', 'right_wrist',
 'left_hip', 'right_hip', 'left_knee', 'right_knee', 'left_ankle',
 'right_ankle']
"""

import numpy as np

NUM_JOINTS = 15

# per-joint weights of the temporal-continuity loss
# (reference ``ROOTJOINTCONT``, hybrid_dataloader.py:20)
ROOT_JOINT_CONT = np.array(
    [0, 0.2, 0.8, 0.8, 0.8, 0.2, 0.2, 0.1, 0.1, 0.8, 0.8, 0.2, 0.2, 0.1, 0.1],
    dtype=np.float32)
