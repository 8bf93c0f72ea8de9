"""Bbox-prompted keypoint detection: the ViTPose model and the glue around it.

Counterpart of `multiply_tpu/preprocessing/vitpose.py`. `VitPoseDetector`
reads a local `from_pretrained` directory (`utils/hf_checkpoint.py`), runs the
network of `models/vitpose.py` on the caller's device, all boxes of a frame in
one forward, with the host pre- and post-processing of
`vitpose_processing.py`. `detect_and_track` runs any detector callable
`(image, boxes) -> [(17, 3)]` on the prompt boxes, drops weak and duplicate
skeletons and matches the survivors to the tracked persons.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.vitpose import VitPose, VitPoseConfig
from ..utils import hf_checkpoint
from .matching import match_detections_to_tracks, skeleton_nms
from .vitpose_processing import ProcessorConfig, postprocess, preprocess


class VitPoseDetector:
    """Bbox-prompted keypoint detector.

    checkpoint: a local `from_pretrained` directory of a
        `VitPoseForPoseEstimation` (`config.json`, then `model.safetensors`,
        its shards or `pytorch_model.bin`, and `preprocessor_config.json`
        where there is one; else the processor's defaults).
    config: the dict that a `config.json` holds, for a model with its
        initial weights (the tests' path); the input size is then the
        backbone's `image_size`.
    device: where the network runs.
    """

    def __init__(self, checkpoint: str | None = None, config: dict | None = None, device="cuda"):
        self.device = torch.device(device)
        if checkpoint is not None:
            if not os.path.isdir(checkpoint):
                raise FileNotFoundError(f"ViTPose checkpoint directory not found: {checkpoint} "
                                        "(pass a local from_pretrained directory)")
            self.cfg = VitPoseConfig.from_dict(hf_checkpoint.read_config(checkpoint))
            state = {k: v.float() if v.is_floating_point() else v
                     for k, v in hf_checkpoint.read_state_dict(checkpoint).items()}
            with torch.device("meta"):  # no initialisation that the weights would overwrite
                self.model = VitPose(self.cfg)
            self.model.load_state_dict(state, strict=True, assign=True)
            self.processor = ProcessorConfig(hf_checkpoint.read_preprocessor_config(checkpoint))
        elif config is not None:
            self.cfg = VitPoseConfig.from_dict(config)
            self.model = VitPose(self.cfg)
            self.processor = ProcessorConfig(size=self.cfg.image_size)
        else:
            raise ValueError("need checkpoint or config")
        self.model.to(self.device)

    def __call__(self, image: np.ndarray, boxes: np.ndarray) -> list[np.ndarray]:
        """image: (H, W, 3) uint8 RGB; boxes: (D, 4) COCO [x, y, w, h].
        Returns D arrays (K, 3) float32 [x, y, confidence] in image pixels."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        if len(boxes) == 0:
            return []
        pixels = torch.from_numpy(preprocess(image, boxes, self.processor)).to(self.device)
        with torch.inference_mode():
            heatmaps = self.model(pixels).float().cpu().numpy()
        kp, scores = postprocess(heatmaps, boxes, self.processor)
        return [np.concatenate([kp[i], scores[i][:, None]], axis=-1).astype(np.float32) for i in range(len(boxes))]


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
