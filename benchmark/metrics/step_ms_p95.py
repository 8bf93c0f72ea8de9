"""95th percentile over the window's steps of the interval between the CUDA
events recorded on the stream at consecutive step boundaries: stalls such as
epoch turnover or a producer behind (the intervals that hold the profiler's
start or stop are left out)."""

import numpy as np


def read(run: dict):
    ms = run.get("step_ms")
    return float(np.percentile(ms, 95)) if ms else None
