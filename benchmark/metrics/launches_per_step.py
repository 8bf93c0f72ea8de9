"""Device kernels plus memcpy/memset in the trace, over the traced steps."""


def read(run: dict):
    t = run.get("trace")
    if not t or not run.get("traced_steps"):
        return None
    return t["launches"] / run["traced_steps"]
