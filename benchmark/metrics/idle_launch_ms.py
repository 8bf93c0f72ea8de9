"""Device idle ms per traced step (no device event running, as `device_idle`
counts) while `step.forward`, `step.backward` or `step.update` is open: the
card waiting for the host's launches. Read through `benchmark/spans.py`."""

from benchmark import spans


def read(run: dict):
    return spans.metric(run, "idle_launch_ms")
