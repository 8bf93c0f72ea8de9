"""The whole step's share of the card's FP32 peak: model FLOPs a step
(`kernels.step_flops`) times the traced steps, over the traced window, in %."""


def read(run: dict):
    t, peak, flops = run.get("trace"), run.get("peak"), run.get("flops")
    if not t or not peak or not flops or not run.get("traced_steps") or t["window_s"] <= 0:
        return None
    return 100.0 * flops["total"] * run["traced_steps"] / t["window_s"] / peak["fp32_flops"]
