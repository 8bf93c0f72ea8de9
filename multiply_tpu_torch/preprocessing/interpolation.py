"""SO(3) interpolation of missing tracker frames.

Counterpart of `multiply_tpu/preprocessing/interpolation.py` (host numpy and
scipy, the same code): when a person's detection drops out for a span of
frames, each joint's rotation is slerped and the translation interpolated
linearly from the surrounding valid frames.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def interpolate_missing_frames(poses: np.ndarray, trans: np.ndarray,
                               valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fill the invalid frames of one person's (F, 72) axis-angle poses and
    (F, 3) translations; `valid` (F,) marks the frames with a detection.
    Leading and trailing gaps copy the nearest valid frame; valid frames keep
    their values exactly."""
    F = poses.shape[0]
    valid_idx = np.where(valid)[0]
    if len(valid_idx) == 0:
        return poses.copy(), trans.copy()
    out_poses, out_trans = poses.copy(), trans.copy()
    key_times = valid_idx.astype(np.float64)
    for j in range(24):
        cols = slice(3 * j, 3 * j + 3)
        if len(valid_idx) == 1:
            out_poses[:, cols] = np.broadcast_to(poses[valid_idx[0], cols], (F, 3))
            continue
        slerp = Slerp(key_times, Rotation.from_rotvec(poses[valid_idx, cols]))
        t = np.clip(np.arange(F, dtype=np.float64), key_times[0], key_times[-1])
        out_poses[:, cols] = slerp(t).as_rotvec()
    for d in range(3):
        out_trans[:, d] = np.interp(np.arange(F), valid_idx, trans[valid_idx, d])
    out_poses[valid_idx] = poses[valid_idx]
    out_trans[valid_idx] = trans[valid_idx]
    return out_poses, out_trans
