"""Device ms per traced step of GEMM kernels (by name, `traces.kernel_category`)."""

from benchmark.traces import category_s


def read(run: dict):
    t = run.get("trace")
    if not t or not run.get("traced_steps"):
        return None
    s = category_s(t, "gemm")
    return 1e3 * s / run["traced_steps"] if s > 0 else None
