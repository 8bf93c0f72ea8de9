"""One minus the union of device event intervals over the traced window, in %."""


def read(run: dict):
    t = run.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
