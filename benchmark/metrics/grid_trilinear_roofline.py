"""Least time of the traced `grid_trilinear` calls (`kernels.grid_bound`)
over the device time of `grid_trilinear_kernel` in the trace, in %."""

from benchmark.kernels import grid_bound
from benchmark.traces import kernel_s


def read(run: dict):
    t, peak = run.get("trace"), run.get("peak")
    calls = [c for c in run.get("kernel_calls") or [] if c[0] == "grid_trilinear"]
    if not t or not peak or not calls:
        return None
    seconds, n = kernel_s(t, "grid_trilinear_kernel")
    if n != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(grid_bound(*c[1:], peak)[0] for c in calls) / seconds
