"""Reduction of a `torch.profiler` trace (CUDA activity only) to device
numbers: the device events of the traced steps, their union, the idle gaps
labelled by where the host was, and time by kernel name and category.

The harness launches a marker kernel (`torch.cuda._sleep(1)`, `spin_kernel`)
on entering and on leaving each traced `train_step`, so the markers alternate
start, end, start, ... and a gap between device events is inside a step
(the host enqueueing) or between steps (the trainer's loop: the queue, the
producer's batch, the copies to the card).
"""

from __future__ import annotations

import json

MARKER = "spin_kernel"
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
# a frozen copy of the port's `utils/profiling.py::kernel_category`
HAND_WRITTEN = ("nn1_kernel", "grid_trilinear_kernel")
GEMM_MARKS = ("gemm", "gemv", "xmma", "cutlass")
REDUCTION_MARKS = ("reduce", "softmax", "norm", "scan")


def kernel_category(name: str) -> str:
    low = name.lower()
    for kernel in HAND_WRITTEN:
        if kernel in name:
            return kernel
    if any(t in low for t in GEMM_MARKS):
        return "gemm"
    if low.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    if "elementwise" in low:
        return "elementwise"
    if any(t in low for t in REDUCTION_MARKS):
        return "reduction"
    return "other"


def load_events(path: str) -> list[dict]:
    """Device events {name, start, end} in microseconds, by start."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = [
        {"name": str(e.get("name", "")), "start": float(e["ts"]), "end": float(e["ts"]) + float(e.get("dur", 0.0))}
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENTS
    ]
    out.sort(key=lambda e: e["start"])
    return out


def reduce_trace(events: list[dict]) -> dict | None:
    """busy_s, window_s, launches, the work events, time by name and the idle
    gaps by label; None without markers or work."""
    markers = [e for e in events if MARKER in e["name"]]
    work = [e for e in events if MARKER not in e["name"]]
    if len(markers) < 2 or not work:
        return None
    t0, t1 = markers[0]["start"], markers[-1]["end"]
    work = [e for e in work if e["start"] >= t0 and e["end"] <= t1]
    starts = [m["start"] for m in markers]
    inside, between = "inside train_step (host enqueue)", "between train_step calls (loop, producer)"
    gaps = {inside: 0.0, between: 0.0}

    def add_gap(a: float, b: float) -> None:
        """Split [a, b) at the markers: after an odd count of them the host is inside a step."""
        cuts = [a] + [t for t in starts if a < t < b] + [b]
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            count = sum(1 for t in starts if t <= lo)
            gaps[inside if count % 2 else between] += hi - lo

    busy, cur_s, cur_e = 0.0, None, None
    for e in work:
        if cur_e is None or e["start"] > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            add_gap(t0 if cur_e is None else cur_e, e["start"])
            cur_s, cur_e = e["start"], e["end"]
        else:
            cur_e = max(cur_e, e["end"])
    busy += cur_e - cur_s
    add_gap(cur_e, t1)
    by_name: dict[str, float] = {}
    for e in work:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (e["end"] - e["start"])
    return {
        "busy_s": busy * 1e-6,
        "window_s": (t1 - t0) * 1e-6,
        "launches": len(work),
        "work": work,
        "by_name_s": {k: v * 1e-6 for k, v in by_name.items()},
        "gaps_s": {k: v * 1e-6 for k, v in gaps.items()},
    }


def category_s(reduced: dict, category: str) -> float:
    return sum(s for name, s in reduced["by_name_s"].items() if kernel_category(name) == category)


def kernel_s(reduced: dict, kernel: str) -> tuple[float, int]:
    """(device seconds, events) of one hand-written kernel."""
    evs = [e for e in reduced["work"] if kernel in e["name"]]
    return sum(e["end"] - e["start"] for e in evs) * 1e-6, len(evs)
