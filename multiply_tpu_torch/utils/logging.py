"""Metrics logging, one JSON line per call appended to
`<run_dir>/metrics.jsonl`, and a `torch.profiler` trace scope.

Counterpart of `multiply_tpu/utils/logging.py`.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

TRACE_FILE = "trace.json"


class MetricsLogger:
    def __init__(self, run_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, metrics: dict, step: int | None = None, epoch: int | None = None) -> None:
        rec = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        if epoch is not None:
            rec["epoch"] = int(epoch)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


@contextmanager
def profile_trace(log_dir: str):
    """`torch.profiler` scope that writes `<log_dir>/trace.json` (Chrome
    trace format) when it closes. With a CUDA device it traces the card's
    activity alone (the lighter event load), otherwise the host's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activity = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[activity]) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
