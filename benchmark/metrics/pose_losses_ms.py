"""Mean device ms between the CUDA events around the mesh losses' forward
(`TrainStep._pose_step_losses`) over the window's pose-only steps."""

import numpy as np


def read(run: dict):
    ms = run.get("pose_losses_ms")
    return float(np.mean(ms)) if ms else None
