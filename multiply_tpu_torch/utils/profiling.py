"""Spans and counters of the program, and training-step profiling.

Spans and counters: `span(name)` (a context manager) and `count(name, n)`
record into one process-wide `Recorder`, always on, in memory only: a bounded
ring of `RING` entries with a `dropped` count, read by `records()` and
cleared by `reset()`. A span's clock is `time.time_ns()`, the clock of a
`torch.profiler` chrome trace (its `ts` in microseconds plus the file's
`baseTimeNanoseconds`), so spans and device events line up. A span's parent
is the span open around it on the same thread; its id and a counter's are
the thread's current id (`set_id`). `Trainer.train_epoch` numbers each batch
(`new_id`, unique in the process) and sets that number in the producer and in
the main thread, so the spans and counters of one batch share it.

Profiling: `profile_training_steps` (`cli/train.py --profile N`) runs two
warm steps, then N traced ones, all through `Trainer.train_epoch` (producer,
queue, the configured modes), inside `utils/logging.py::profile_trace`, whose
trace (`<log_dir>/trace.json`) `summarize_trace` reads back; the device
events are grouped into GEMM, the two hand-written kernels by name,
elementwise, reduction, memcpy/memset and other, as rows {category,
total_ms, count, pct}. Beside them it prints each span name's count, total
and self time and each counter's total, and writes the tables to
`<log_dir>/summary.json` and the traced steps' spans and counters to
`<log_dir>/spans.json`.

    python -m multiply_tpu_torch.cli.train --conf ... --profile 20
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import NamedTuple

from .logging import TRACE_FILE, profile_trace

HAND_WRITTEN = ("nn1_kernel", "grid_trilinear_kernel")  # csrc/nn1.cu, csrc/grid_trilinear.cu
GEMM_MARKS = ("gemm", "gemv", "xmma", "cutlass")
REDUCTION_MARKS = ("reduce", "softmax", "norm", "scan")
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")  # trace categories of work on the card
RING = 1 << 17  # spans, and counters by (name, id), kept before the oldest are dropped
WARM_STEPS = 2


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


class SpanRecord(NamedTuple):
    name: str
    tid: int  # threading.get_native_id()
    start_ns: int  # time.time_ns()
    end_ns: int
    parent: str | None  # the name of the span open around it on the same thread
    id: int | None  # the thread's current id when the span closed


class _Thread(threading.local):
    """A thread's open spans, current id and native id."""

    def __init__(self):
        self.stack: list[str] = []
        self.id: int | None = None
        self.tid = threading.get_native_id()


class _Span:
    __slots__ = ("rec", "name", "parent", "start")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._local.stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:  # an exception leaving the span closes it too
        end = time.time_ns()
        rec = self.rec
        local = rec._local
        local.stack.pop()
        item = (self.name, local.tid, self.start, end, self.parent, local.id)
        with rec._lock:
            if len(rec._spans) == RING:
                rec._dropped += 1
            rec._spans.append(item)
        return False


class Recorder:
    """Spans and counters in memory: the newest `RING` spans and the newest
    `RING` counters (by name and id); what is pushed out counts in
    `dropped`. Thread-safe; nothing is written or printed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = _Thread()
        self._ids = itertools.count()
        self.reset()

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def new_id(self) -> int:
        """A number no other call in the process gets."""
        return next(self._ids)

    def set_id(self, ident: int | None) -> None:
        """The id that this thread's spans and counters are recorded under."""
        self._local.id = ident

    def count(self, name: str, n: int = 1) -> None:
        key = (name, self._local.id)
        with self._lock:
            if key in self._counts:
                self._counts[key] += n
                return
            if len(self._counts) == RING:
                self._counts.popitem(last=False)
                self._dropped += 1
            self._counts[key] = n

    def records(self) -> dict:
        """{"spans": [SpanRecord] in the order they closed, "counters":
        [(name, id, total)], "dropped": spans and counters pushed out}."""
        with self._lock:
            spans, counts, dropped = list(self._spans), list(self._counts.items()), self._dropped
        return {"spans": [SpanRecord(*s) for s in spans], "counters": [(k[0], k[1], n) for k, n in counts],
                "dropped": dropped}

    def reset(self) -> None:
        with self._lock:
            self._spans: deque = deque(maxlen=RING)
            self._counts: OrderedDict = OrderedDict()
            self._dropped = 0


RECORDER = Recorder()
span, count, new_id, set_id = RECORDER.span, RECORDER.count, RECORDER.new_id, RECORDER.set_id
records, reset = RECORDER.records, RECORDER.reset


def span_table(spans: list) -> list[dict]:
    """Rows {name, count, total_ms, self_ms} by name, largest total first;
    self time is the duration less that of the spans directly inside."""
    rows: dict[str, dict] = {}
    for s in spans:
        row = rows.setdefault(s.name, {"name": s.name, "count": 0, "total_ms": 0.0, "self_ms": 0.0})
        ms = (s.end_ns - s.start_ns) * 1e-6
        row["count"] += 1
        row["total_ms"] += ms
        row["self_ms"] += ms
    for s in spans:
        if s.parent in rows:
            rows[s.parent]["self_ms"] -= (s.end_ns - s.start_ns) * 1e-6
    return sorted(rows.values(), key=lambda r: -r["total_ms"])


def counter_table(counters: list, ids: set, steps: int) -> list[dict]:
    """Rows {name, total, per_step} of the counters recorded under `ids`."""
    totals: dict[str, int] = {}
    for name, ident, n in counters:
        if ident in ids:
            totals[name] = totals.get(name, 0) + n
    return [{"name": k, "total": v, "per_step": v / max(steps, 1)} for k, v in sorted(totals.items())]


# ---------------------------------------------------------------------------
# device trace
# ---------------------------------------------------------------------------


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


def print_spans(span_rows: list[dict], counter_rows: list[dict]) -> None:
    print(f"{'span':<28} {'count':>8} {'total_ms':>10} {'self_ms':>10}")
    for r in span_rows:
        print(f"{r['name']:<28} {r['count']:>8} {r['total_ms']:>10.2f} {r['self_ms']:>10.2f}")
    print(f"{'counter':<28} {'total':>12} {'per_step':>12}")
    for r in counter_rows:
        print(f"{r['name']:<28} {r['total']:>12} {r['per_step']:>12.1f}")


# ---------------------------------------------------------------------------
# --profile N
# ---------------------------------------------------------------------------


def _epoch_steps(trainer, n_steps: int) -> None:
    """`n_steps` steps through `train_epoch`, epoch after epoch; an epoch
    that ran to its end advances `trainer.epoch`, as `fit` does."""
    done = 0
    while done < n_steps:
        out = trainer.train_epoch(max_steps=n_steps - done)
        steps = int(out["n_joint"] + out["n_pose_only"] + out["n_delayed_pose"])
        if steps == 0:
            raise RuntimeError(f"epoch {trainer.epoch} made no step")
        done += steps
        if done < n_steps:
            trainer.epoch += 1


def profile_training_steps(trainer, n_steps: int, log_dir: str) -> list[dict]:
    """Two warm steps, then `n_steps` traced ones, through the trainer's own
    loop; print the device table and the span and counter tables, write them
    to `<log_dir>/summary.json` with the steps and their wall time, and the
    traced steps' spans and counters to `<log_dir>/spans.json`. Over a ray
    group this traces rank 0, the other ranks following its steps."""
    os.makedirs(log_dir, exist_ok=True)
    _epoch_steps(trainer, WARM_STEPS)
    t0_ns = time.time_ns()
    with profile_trace(log_dir):
        t0 = time.time()
        _epoch_steps(trainer, n_steps)  # ends in a wait for the card (the step's update)
        wall = time.time() - t0
    t1_ns = time.time_ns()

    rows = summarize_trace(log_dir)
    print_summary(rows, wall=wall, steps=n_steps)
    rec = records()
    spans = [s for s in rec["spans"] if t0_ns <= s.start_ns and s.end_ns <= t1_ns]
    ids = {s.id for s in spans if s.name == "step"}
    span_rows, counter_rows = span_table(spans), counter_table(rec["counters"], ids, n_steps)
    print_spans(span_rows, counter_rows)
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump({"steps": n_steps, "wall_s": wall, "rows": rows, "spans": span_rows, "counters": counter_rows},
                  f, indent=1)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"clock": "time.time_ns", "dropped": rec["dropped"], "spans": [s._asdict() for s in spans],
                   "counters": [{"name": k, "id": i, "n": n} for k, i, n in rec["counters"] if i in ids]}, f)
    return rows
