"""SAM refinement stage: turn the rendered instance masks and projected joints
of `stage_instance_mask/<epoch>` into refined per-person mask logits,
`stage_sam_mask/<epoch>/sam_opt_mask.npy` (F, P, H, W).

Counterpart of `multiply_tpu/engine/sam_stage.py`, with its three segmenters:
  * `SamSegmenter`: per frame, `set_image` once, then per person the prompts
    of `build_sam_prompts` and three chained predictions, each fed the last
    one's low-resolution logits; the predictor is `models/sam.py`'s
    `SamPredictor` (the image embedding stays on the card) or anything with
    its `set_image` / `predict` contract, such as `ColorPromptPredictor`;
  * `PriorSegmenter`: without a SAM checkpoint, the rendered instance masks
    themselves (+-8), so the refinement loop and its files still run.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.io import atomic_np_save
from ..utils.resize import resize_linear
from .instance_masks import build_sam_prompts


class PriorSegmenter:
    """Logits +-8 from `stage_instance_mask/<epoch>`, written to
    `stage_sam_mask/<epoch>/sam_opt_mask.npy` (F, P, H, W)."""

    def __call__(self, epoch: int, run_dir: str = ".") -> np.ndarray:
        stage = os.path.join(run_dir, "stage_instance_mask", f"{epoch:05d}")
        masks = np.load(os.path.join(stage, "all_person_smpl_mask.npy"))
        logits = np.where(masks, 8.0, -8.0).astype(np.float32)
        out_dir = os.path.join(run_dir, "stage_sam_mask", f"{epoch:05d}")
        os.makedirs(out_dir, exist_ok=True)
        atomic_np_save(os.path.join(out_dir, "sam_opt_mask.npy"), logits)
        return logits


class ColorPromptPredictor:
    """A checkpoint-free predictor with `SamPredictor`'s contract that
    segments by colour: a pixel's logit grows with its distance to the nearest
    negative point's colour and falls with its distance to the nearest
    positive point's. The mask prior adds a weak term and the box gates the
    output, as the three chained SAM predictions use them. Bad prompts give
    bad masks, so the refinement loop is exercised without SAM weights."""

    def __init__(self, sharpness: float = 40.0, prior_weight: float = 0.25):
        self.sharpness = sharpness
        self.prior_weight = prior_weight
        self._img: np.ndarray | None = None

    def set_image(self, img: np.ndarray) -> None:
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        self._img = img

    def predict(self, point_coords, point_labels, box, mask_input_logits):
        img = self._img
        H, W = img.shape[:2]
        pts = np.asarray(point_coords, np.int64).reshape(-1, 2)
        labels = np.asarray(point_labels).reshape(-1)
        colors = img[np.clip(pts[:, 1], 0, H - 1), np.clip(pts[:, 0], 0, W - 1)]  # (N, 3)

        pos = colors[labels == 1]
        if len(pos) == 0:
            return np.full((H, W), -8.0, np.float32)
        d_pos = np.linalg.norm(img[None] - pos[:, None, None], axis=-1).min(0)
        neg = colors[labels == 0]
        if len(neg):
            d_neg = np.linalg.norm(img[None] - neg[:, None, None], axis=-1).min(0)
        else:
            d_neg = np.full((H, W), 0.35, np.float32)
        logits = self.sharpness * (np.minimum(d_neg, 0.35) - d_pos - 0.05)

        if mask_input_logits is not None:
            prior = np.asarray(mask_input_logits, np.float32)
            if prior.shape != (H, W):
                side = max(H, W)
                prior = resize_linear(prior, (side, side))[:H, :W]
            logits = logits + self.prior_weight * np.clip(prior, -8.0, 8.0)

        logits = np.minimum(logits, 8.0)
        if box is not None:  # pixels outside the box end at -8 whatever their colour
            x0, y0, x1, y1 = np.asarray(box, np.int64)
            in_box = np.zeros((H, W), bool)
            in_box[max(0, y0): min(H, y1 + 1), max(0, x0): min(W, x1 + 1)] = True
            logits = np.where(in_box, logits, -8.0)
        return np.clip(logits, -12.0, 12.0).astype(np.float32)


class SamSegmenter:
    """The promptable-segmentation stage. `predictor` has
        set_image(rgb uint8 (H, W, 3))
        predict(point_coords, point_labels, box, mask_input_logits) -> logits
    and `images` holds one uint8 RGB frame per frame index, or a callable
    that returns it (read when the stage runs)."""

    def __init__(self, predictor, images: list, seed: int = 42):
        self.predictor = predictor
        self.images = images
        self.seed = seed

    def __call__(self, epoch: int, run_dir: str = ".") -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        stage = os.path.join(run_dir, "stage_instance_mask", f"{epoch:05d}")
        masks = np.load(os.path.join(stage, "all_person_smpl_mask.npy"))  # (F, P, H, W)
        kps = np.load(os.path.join(stage, "2d_keypoint.npy"))  # (F, P, 27, 2)

        out_frames = []
        for f, img in enumerate(self.images):
            self.predictor.set_image(img() if callable(img) else img)
            person_logits = []
            for pr in build_sam_prompts(masks[f], kps[f], rng):
                logits = pr["mask_prior_logits"]
                for _ in range(3):  # three chained refinements
                    logits = self.predictor.predict(point_coords=pr["points"], point_labels=pr["labels"],
                                                    box=pr["box"], mask_input_logits=logits)
                person_logits.append(self._to_full_res(logits, masks.shape[-2:]))
            out_frames.append(np.stack(person_logits, axis=0))

        out = np.stack(out_frames, axis=0).astype(np.float32)
        out_dir = os.path.join(run_dir, "stage_sam_mask", f"{epoch:05d}")
        os.makedirs(out_dir, exist_ok=True)
        atomic_np_save(os.path.join(out_dir, "sam_opt_mask.npy"), out)
        return out

    def _to_full_res(self, logits: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
        if logits.shape == tuple(hw):
            return logits
        if hasattr(self.predictor, "logits_to_full_res"):
            return self.predictor.logits_to_full_res(logits)
        # the frame sits in the top-left of the predictor's square input
        H, W = hw
        side = max(H, W)
        return resize_linear(np.asarray(logits, np.float32), (side, side))[:H, :W]
