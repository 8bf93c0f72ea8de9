"""Mean host ms inside `train_step` over the window's steps: the enqueue,
and the waits the step makes on the card."""

import numpy as np


def read(run: dict):
    ms = run.get("step_host_ms")
    return float(np.mean(ms)) if ms else None
