"""SAM refinement stage without a SAM checkpoint.

Counterpart of `multiply_tpu/engine/sam_stage.py::PriorSegmenter`: the
refined logits are the rendered instance masks themselves (+-8), written where
the promptable segmenter would write its own, so the refinement loop and its
files run without SAM weights. SAM itself (`SamSegmenter`,
`ColorPromptPredictor`) is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.io import atomic_np_save


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
