"""Mean host ms from the return of one `train_step` call to the start of the
next, over the window's steps: the trainer's loop, its queue and producer."""

import numpy as np


def read(run: dict):
    gaps = run.get("loop_gap_ms")
    return float(np.mean(gaps)) if gaps else None
