"""SMPL vertex-part segmentation: sampling weights for the surface loss.

Counterpart of `multiply_tpu/body/segmentation.py`: the SMPL-surface loss
samples posed vertices except those of the head, hands and feet, read from
the standard `smpl_vert_segmentation.json` (a user-provided asset).
"""

from __future__ import annotations

import json

import numpy as np

EXCLUDED_PARTS = ("head", "rightHand", "leftHand", "rightFoot", "leftFoot", "leftHandIndex1", "rightHandIndex1")


def surface_sample_logits(segmentation_path: str, num_verts: int = 6890) -> np.ndarray:
    """Categorical-sampling logits: 0 for body vertices, -1e9 for excluded parts."""
    with open(segmentation_path) as f:
        seg = json.load(f)
    logits = np.zeros(num_verts, np.float32)
    for part in EXCLUDED_PARTS:
        logits[np.asarray(seg.get(part, []), np.int64)] = -1e9
    return logits
