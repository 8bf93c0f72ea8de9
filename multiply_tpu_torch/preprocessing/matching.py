"""Detection-to-track matching for pose estimators.

Counterpart of `multiply_tpu/preprocessing/matching.py` (host numpy and
scipy, the same code): duplicate skeletons are dropped when both their
centers and their mean keypoint distance are close, and the survivors are
assigned to the tracked persons by the Hungarian method on center distance,
with a gate in pixels.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def keypoint_center(kps: np.ndarray) -> np.ndarray:
    """Confidence-weighted center of a (J, 3) keypoint set."""
    w = np.maximum(kps[:, 2:3], 1e-6)
    return (kps[:, :2] * w).sum(0) / w.sum()


def skeleton_nms(detections: list[np.ndarray], center_thresh: float = 50.0,
                 kp_thresh: float = 30.0) -> list[np.ndarray]:
    """Keep the most confident of each group of duplicate (J, 3) detections."""
    keep: list[np.ndarray] = []
    for det in sorted(detections, key=lambda d: -float(d[:, 2].mean())):
        dup = any(
            np.linalg.norm(keypoint_center(det) - keypoint_center(k)) < center_thresh
            and np.linalg.norm(det[:, :2] - k[:, :2], axis=-1).mean() < kp_thresh
            for k in keep
        )
        if not dup:
            keep.append(det)
    return keep


def match_detections_to_tracks(detections: list[np.ndarray], track_centers: np.ndarray,
                               gate_px: float = 200.0) -> list[int | None]:
    """Per track of (P, 2) centers, the index of its matched detection, or
    None where no detection lies within `gate_px`."""
    P = len(track_centers)
    if not detections:
        return [None] * P
    det_centers = np.stack([keypoint_center(d) for d in detections])
    cost = np.linalg.norm(det_centers[:, None, :] - track_centers[None, :, :], axis=-1)
    out: list[int | None] = [None] * P
    for r, c in zip(*linear_sum_assignment(cost)):
        if cost[r, c] <= gate_px:
            out[c] = int(r)
    return out
