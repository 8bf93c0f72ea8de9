"""Metrics logging: one JSON line per call, appended to `<run_dir>/metrics.jsonl`.

Counterpart of `multiply_tpu/utils/logging.py::MetricsLogger` (its trace
scope, `profile_trace`, is not ported yet).
"""

from __future__ import annotations

import json
import os
import time


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
