"""JOINT15 skeleton constants the training, eval and render paths need: the
port's own copy of the relevant part of ``snipper_tpu/data/skeleton.py``.

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

# JOINT15 -> the PoseTrack (18-slot) and COCO (19-slot) result layouts
# (hybrid_dataloader.py:18-41)
JOINT15_TO_POSETRACK = [2, 1, 2, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]
JOINT15_TO_COCO = [0, 2, 1, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]

# limbs for rendering (hybrid_dataloader.py:22-37)
SKELETON_EDGES = [
    (0, 9), (0, 10), (0, 2), (2, 3), (2, 4), (2, 1), (3, 5), (5, 7),
    (4, 6), (6, 8), (9, 11), (11, 13), (10, 12), (12, 14),
]
