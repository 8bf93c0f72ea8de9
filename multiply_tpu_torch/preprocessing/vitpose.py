"""Bbox-prompted keypoint detection: the glue around a pose model.

Counterpart of `multiply_tpu/preprocessing/vitpose.py`. `detect_and_track`
is ported: any detector callable `(image, boxes) -> [(17, 3)]` runs on the
prompt boxes, weak and duplicate skeletons are dropped, and the survivors are
matched to the tracked persons. The ViTPose model (`VitPoseDetector`) is not
ported yet and is refused: JAX takes it from `transformers`, which the port
does not use (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np

from . import NOT_PORTED
from .matching import match_detections_to_tracks, skeleton_nms


class VitPoseDetector:
    """The ViTPose model; refused until a native port lands."""

    def __init__(self, checkpoint: str | None = None, config=None):
        raise NotImplementedError(f"the ViTPose model (checkpoint {checkpoint!r}) {NOT_PORTED}")


def detect_and_track(detector, image: np.ndarray, boxes: np.ndarray, track_centers: np.ndarray,
                     conf_floor: float = 0.3) -> np.ndarray:
    """One frame: (P, 17, 3) keypoints of the P tracked persons, zero rows for
    the tracks that no detection of mean confidence >= `conf_floor` matched."""
    P = len(track_centers)
    dets = [d for d in detector(image, boxes) if float(d[:, 2].mean()) >= conf_floor]
    dets = skeleton_nms(dets)
    assign = match_detections_to_tracks(dets, np.asarray(track_centers, np.float32))
    out = np.zeros((P, 17, 3), np.float32)
    for p, di in enumerate(assign):
        if di is not None:
            out[p] = dets[di]
    return out
