"""Least time of the traced `nn1` calls (from their shapes, `kernels.nn1_bound`)
over the device time of `nn1_kernel` in the trace, in %."""

from benchmark.kernels import nn1_bound
from benchmark.traces import kernel_s


def read(run: dict):
    t, peak = run.get("trace"), run.get("peak")
    calls = [c for c in run.get("kernel_calls") or [] if c[0] == "nn1"]
    if not t or not peak or not calls:
        return None
    seconds, n = kernel_s(t, "nn1_kernel")
    if n != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(nn1_bound(*c[1:], peak)[0] for c in calls) / seconds
