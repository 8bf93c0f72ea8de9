"""Training-step profiling: trace N steps with `torch.profiler` and print the
card's kernel time by category.

Counterpart of `multiply_tpu/utils/profiling.py`: two warm steps, then N
traced ones inside `utils/logging.py::profile_trace`, whose trace
(`<log_dir>/trace.json`) `summarize_trace` reads back; the device events are
grouped into GEMM, the two hand-written kernels by name, elementwise,
reduction, memcpy/memset and other, as rows {category, total_ms, count, pct},
printed and written to `<log_dir>/summary.json`.

    python -m multiply_tpu_torch.cli.train --conf ... --profile 20
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np

from .logging import TRACE_FILE, profile_trace

HAND_WRITTEN = ("nn1_kernel", "grid_trilinear_kernel")  # csrc/nn1.cu, csrc/grid_trilinear.cu
GEMM_MARKS = ("gemm", "gemv", "xmma", "cutlass")
REDUCTION_MARKS = ("reduce", "softmax", "norm", "scan")
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")  # trace categories of work on the card


def is_gemm(name: str) -> bool:
    return any(t in name.lower() for t in GEMM_MARKS)


def kernel_category(name: str) -> str:
    """The category of one device kernel (or copy) by its name."""
    low = name.lower()
    for kernel in HAND_WRITTEN:
        if kernel in name:
            return kernel
    if is_gemm(name):
        return "gemm"
    if low.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    if "elementwise" in low:
        return "elementwise"
    if any(t in low for t in REDUCTION_MARKS):
        return "reduction"
    return "other"


def summarize_trace(log_dir: str) -> list[dict]:
    """Device time by category from the newest trace under `log_dir`: rows
    {category, total_ms, count, pct}, largest first ([] without device events)."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", TRACE_FILE), recursive=True), key=os.path.getmtime)
    if not paths:
        return []
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    totals: dict[str, list] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_EVENTS:
            continue
        row = totals.setdefault(kernel_category(str(e.get("name", ""))), [0.0, 0])
        row[0] += float(e.get("dur", 0.0)) / 1000.0  # us -> ms
        row[1] += 1
    grand = sum(v[0] for v in totals.values()) or 1.0
    rows = [{"category": k, "total_ms": v[0], "count": v[1], "pct": 100.0 * v[0] / grand} for k, v in totals.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def print_summary(rows: list[dict], wall: float | None = None, steps: int | None = None) -> None:
    if wall is not None and steps:
        print(f"profiled {steps} steps in {wall:.2f}s ({steps / wall:.2f} steps/s)")
    if not rows:
        print("profile: no device events captured (no CUDA device?)")
        return
    print(f"{'category':<28} {'total_ms':>10} {'count':>8} {'pct':>6}")
    for r in rows:
        print(f"{r['category']:<28} {r['total_ms']:>10.2f} {r['count']:>8} {r['pct']:>5.1f}%")


def profile_training_steps(trainer, n_steps: int, log_dir: str) -> list[dict]:
    """Two warm joint steps, then `n_steps` traced ones; print the table and
    write it to `<log_dir>/summary.json` with the steps and their wall time."""
    from ..engine.train import MODE_JOINT

    os.makedirs(log_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    n_frames = len(trainer.seq)
    batches = [trainer.make_batch(trainer.seq.get_train_item(i % n_frames, rng), MODE_JOINT)
               for i in range(n_steps + 2)]
    trainer.ts.epoch = trainer.epoch
    for b in batches[:2]:
        trainer.ts, logs = trainer.builder.step(trainer.ts, b, generator=trainer.gen)
    float(logs["loss"])  # waits for the card
    with profile_trace(log_dir):
        t0 = time.time()
        for b in batches[2:]:
            trainer.ts, logs = trainer.builder.step(trainer.ts, b, generator=trainer.gen)
        float(logs["loss"])
        wall = time.time() - t0

    rows = summarize_trace(log_dir)
    print_summary(rows, wall=wall, steps=n_steps)
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump({"steps": n_steps, "wall_s": wall, "rows": rows}, f, indent=1)
    return rows
