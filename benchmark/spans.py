"""The program's spans and counters joined to a traced run's device events.

The port records spans in memory (`multiply_tpu_torch/utils/profiling.py`:
name, thread, `time.time_ns()` start and end, parent, batch id); the readers
take them with `profiling.records()` in the benchmark's own process after the
window. The harness's CUDA-only chrome trace (`run["trace_path"]`) stamps
each event with `ts` in microseconds from its `baseTimeNanoseconds`, on the
host's clock, so a span's `(ns - base) / 1000` is a `ts`. The join:

1. reads `baseTimeNanoseconds`, the device events, the runtime's launch
   events (`cuda_runtime`/`cuda_driver`, tied to a device event by
   `args.correlation`), its synchronize calls, and the marker kernels that
   the harness launches at each traced step's entry and exit; the main
   thread is the one that launched the markers;
2. converts the spans to the trace's microseconds and keeps the traced
   steps: the `step` spans between the first and the last marker's launch,
   one for each pair of markers, as many as the harness traced;
3. takes out the drift of the card's clock against the host's. The device
   events come stamped on the card's clock, mapped to the host's by the
   profiler, and the two drift apart in some runs (~175 ppm seen on the H100,
   kernels then appearing to start before their launch). Each `step.sync`
   span waits for a device-to-host copy; the runtime's synchronize call
   returns a wake-up after that copy ends, so the gap between the two,
   fitted linearly over the traced steps, is the drift (at most
   `MAX_DRIFT`), which the join takes out of every device event;
4. checks the clocks in every traced step, and returns None where a check
   fails, where the trace lacks what it needs, where the program records no
   spans (a tree without them), or where a span of a traced batch was
   dropped:
   * each `step` span opens after its entry marker's launch and closes
     before its exit marker's (spans against the trace's host clock);
   * each `step.sync` span holds the copy's launch and the synchronize call
     that waited for it (the copy: the last to end of the device events that
     the main thread launched before the span's end), and that call returns
     no earlier than the copy's end and at most `SYNC_SLACK_US` after it.
     The span's own end comes later still, by the interpreter's return
     (up to ~0.3 ms where the producer holds the interpreter lock), which
     is no clock's error and is reported, not bounded;
   * no device event that the main thread launched between a step's two
     markers starts before that step's `step` span opens.

Per traced step it then reads the spans of the traced batches (their ids),
the card's idle time inside the main thread's launching spans, and the
device events by the span open at their launch (main thread only).
"""

from __future__ import annotations

import bisect
import json

from .traces import DEVICE_EVENTS, MARKER

LAUNCH_EVENTS = ("cuda_runtime", "cuda_driver")
SYNC_SLACK_US = 200.0  # the runtime's synchronize may return this long after the copy it waited for
MAX_DRIFT = 1e-3  # the card's clock against the host's, as a rate: 1,000 ppm
HOST_SPANS = {"queue_wait_ms": "loop.queue_get", "forward_host_ms": "step.forward",
              "backward_host_ms": "step.backward", "sync_wait_ms": "step.sync", "update_host_ms": "step.update"}
LAUNCHING_SPANS = ("step.forward", "step.backward", "step.update")  # the host enqueues while they are open


def program_records() -> dict | None:
    """The program's spans and counters, or None where it records none."""
    try:
        from multiply_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    return records() if callable(records) else None


def load_trace(path: str) -> dict | None:
    """{base_ns, device: [{name, start, end, corr}] by start, launches:
    {correlation: (tid, ts)}, syncs: [(tid, ts, end)] of the runtime's
    synchronize calls by start}, or None without `baseTimeNanoseconds`."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds")
    if base is None:
        return None
    device, launches, syncs = [], {}, []
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_EVENTS:
            device.append({"name": str(e.get("name", "")), "start": start, "end": end, "corr": corr})
        elif e.get("cat") in LAUNCH_EVENTS:
            if corr is not None:
                launches[corr] = (e.get("tid"), start)
            if "Synchronize" in str(e.get("name", "")):
                syncs.append((e.get("tid"), start, end))
    device.sort(key=lambda e: e["start"])
    syncs.sort(key=lambda x: x[1])
    return {"base_ns": int(base), "device": device, "launches": launches, "syncs": syncs}


def drift_rate(anchors: list[tuple[float, float]]) -> float:
    """The least-squares slope of gap against time over (time, gap) pairs."""
    if len(anchors) < 2:
        return 0.0
    tm = sum(t for t, _ in anchors) / len(anchors)
    gm = sum(g for _, g in anchors) / len(anchors)
    den = sum((t - tm) ** 2 for t, _ in anchors)
    return sum((t - tm) * (g - gm) for t, g in anchors) / den if den > 0 else 0.0


def busy_intervals(work: list[dict]) -> list[tuple[float, float]]:
    """The union of the events' [start, end), as sorted disjoint intervals."""
    out: list[list[float]] = []
    for e in sorted(work, key=lambda e: e["start"]):
        if out and e["start"] <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e["end"])
        else:
            out.append([e["start"], e["end"]])
    return [(a, b) for a, b in out]


def idle_inside(busy: list[tuple[float, float]], starts: list[float], t0: float, t1: float, a: float,
                b: float) -> float:
    """Microseconds of [a, b) inside the window [t0, t1] when no interval of
    `busy` (sorted, disjoint; `starts` their starts) covers the card."""
    a, b = max(a, t0), min(b, t1)
    if b <= a:
        return 0.0
    covered = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(busy) and busy[i][0] < b:
        covered += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return (b - a) - covered


def join(run: dict) -> dict | None:
    """The join of the run's trace and the program's spans, computed once a
    run (kept in `run`): {"metrics": {name: value or None}, "clock": the
    offsets checked}, or None where the join is broken."""
    if "span_join" not in run:
        run["span_join"] = _join(run)
    return run["span_join"]


def _join(run: dict) -> dict | None:
    path = run.get("trace_path")
    rec = program_records()
    if not path or rec is None:
        return None
    trace = load_trace(path)
    if trace is None:
        return None
    device, launches = trace["device"], trace["launches"]
    markers = [e for e in device if MARKER in e["name"]]
    if len(markers) < 2 or len(markers) % 2:
        return None
    marker_launch = [launches.get(m["corr"]) for m in markers]
    if None in marker_launch or len({tid for tid, _ in marker_launch}) != 1:
        return None
    main_tid = marker_launch[0][0]
    entry = [ts for _, ts in marker_launch]

    def us(ns: int) -> float:
        return (ns - trace["base_ns"]) / 1000.0

    spans = [(s, us(s.start_ns), us(s.end_ns)) for s in rec["spans"]]
    steps = sorted((x for x in spans if x[0].name == "step" and entry[0] < x[1] and x[2] < entry[-1]),
                   key=lambda x: x[1])
    n = len(steps)
    if n != len(markers) // 2 or n != run.get("traced_steps"):
        return None
    if any(not entry[2 * k] <= a < b <= entry[2 * k + 1] for k, (_, a, b) in enumerate(steps)):
        return None
    ids = [s.id for s, _, _ in steps]
    by_id: dict = {i: [] for i in ids}
    for x in spans:
        if x[0].id in by_id:
            by_id[x[0].id].append(x)
    # a batch's first span is its producer's `producer.item`; none may have been pushed out of the ring
    firsts = [min((a for s, a, _ in by_id[i] if s.name == "producer.item"), default=None) for i in ids]
    if None in firsts or (rec["dropped"] and spans and spans[0][2] >= min(firsts)):
        return None

    # device events the main thread launched, by launch time, and those of each traced step
    main = sorted(((launches[e["corr"]][1], e) for e in device
                   if MARKER not in e["name"] and launches.get(e["corr"], (None,))[0] == main_tid),
                  key=lambda x: x[0])
    main_ts = [ts for ts, _ in main]
    launched = [main[bisect.bisect_right(main_ts, entry[2 * k]):bisect.bisect_left(main_ts, entry[2 * k + 1])]
                for k in range(n)]
    if not all(launched):
        return None
    # each sync span, the copy it waited for, and the runtime's synchronize call on it
    main_syncs = [(a, b) for tid, a, b in trace["syncs"] if tid == main_tid]
    waits = []
    for (step, _, _), own in zip(steps, launched):
        for s, start, end in by_id[step.id]:
            if s.name != "step.sync":
                continue
            before = [(ts, e) for ts, e in own if ts < end]
            if not before:
                return None
            ts, copy = max(before, key=lambda x: x[1]["end"])
            call = next(((a, b) for a, b in main_syncs if ts <= a < end), None)
            if call is None or not start <= ts <= call[0] <= call[1] <= end:
                return None
            waits.append((end, copy, call[1]))
    anchors = [(back, back - copy["end"]) for _, copy, back in waits]
    rate = drift_rate(anchors)
    if not waits or abs(rate) > MAX_DRIFT:
        return None
    ref = anchors[0][0]
    for e in device:
        e["start"] += rate * (e["start"] - ref)
        e["end"] += rate * (e["end"] - ref)

    clock = {"drift_ppm": rate * 1e6, "return_after_copy_us": [back - copy["end"] for _, copy, back in waits],
             "span_end_after_copy_us": [end - copy["end"] for end, copy, _ in waits],
             "first_start_after_us": [min(e["start"] for _, e in own) - a for (_, a, _), own in zip(steps, launched)],
             "entry_launch_us": [a - entry[2 * k] for k, (_, a, _) in enumerate(steps)]}
    if not all(0.0 <= x <= SYNC_SLACK_US for x in clock["return_after_copy_us"]):
        return None
    if min(clock["first_start_after_us"]) < 0:
        return None
    t0, t1 = markers[0]["start"], markers[-1]["end"]
    work = [e for e in device if MARKER not in e["name"] and e["start"] >= t0 and e["end"] <= t1]

    def spans_of(name: str) -> list[tuple]:
        return [x for i in ids for x in by_id[i] if x[0].name == name]

    metrics = {m: sum(b - a for _, a, b in spans_of(name)) / 1000.0 / n for m, name in HOST_SPANS.items()}
    busy = busy_intervals(work)
    starts = [a for a, _ in busy]
    idle = sum(idle_inside(busy, starts, t0, t1, a, b) for name in LAUNCHING_SPANS for _, a, b in spans_of(name))
    metrics["idle_launch_ms"] = idle / 1000.0 / n

    def launched_in(name: str) -> list[dict]:
        out = []
        for _, a, b in spans_of(name):
            out += [e for _, e in main[bisect.bisect_left(main_ts, a):bisect.bisect_right(main_ts, b)]
                    if t0 <= e["start"] and e["end"] <= t1]
        return out

    metrics["update_launches"] = len(launched_in("step.update")) / n
    metrics["sampler_device_ms"] = sum(e["end"] - e["start"] for e in launched_in("render.sampler")) / 1000.0 / n
    pose = [i for i in ids if any(s.name == "producer.pose_batch" for s, _, _ in by_id[i])]
    sdf = [b - a for i in pose for s, a, b in by_id[i] if s.name == "mesh.sdf"]
    metrics["mesh_sdf_ms"] = sum(sdf) / 1000.0 / len(pose) if pose else None
    return {"metrics": metrics, "clock": clock, "steps": n, "ids": ids}


def metric(run: dict, name: str):
    """One metric of the join, or None where the join is broken."""
    joined = join(run)
    return None if joined is None else joined["metrics"][name]
