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
3. checks the spans against the trace's host-side events (the host part,
   `host_join`), and breaks where a check fails, where the trace lacks what
   it needs, where the program records no spans (a tree without them), or
   where a span of a traced batch was dropped:
   * each `step` span opens after its entry marker's launch and closes
     before its exit marker's;
   * each `step.sync` span holds the launch of the copy it waited for (the
     last to end of the device events that the main thread launched before
     the span's end) and the synchronize call after it;
   the spans' own metrics (`HOST_SPANS`, `mesh_sdf_ms`) need no more;
4. takes out the drift of the card's clock against the host's and checks it
   (the device part, `join`). The device events come stamped on the card's
   clock, mapped to the host's by the profiler; the two drift apart in some
   runs (up to ~920 ppm seen on the H100), and in the pose cell's longer
   traced windows the map also jumps by up to ~4 ms (PERF.md, section 6).
   The runtime's synchronize call returns a wake-up after the copy it waited
   for ends, so the gap between the two, fitted linearly over the traced
   steps, is the drift (at most `MAX_DRIFT`), which the join takes out of
   every device event. It breaks where, after that:
   * a synchronize call returns before its copy's end or more than
     `SYNC_SLACK_US` after it. The span's own end comes later still, by the
     interpreter's return (up to ~0.3 ms where the producer holds the
     interpreter lock), which is no clock's error and is reported, not
     bounded;
   * a device event that the main thread launched between a step's two
     markers starts before that step's `step` span opens.
   Where either part breaks, `run["span_join_broken"]` names the check and
   the numbers it compared (`Broken`), and `summary` gives the account for
   the result line.

Per traced step the host part reads the spans of the traced batches (their
ids); the device part the card's idle time inside the main thread's launching
spans, and the device events by the span open at their launch (main thread
only).
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


class Broken(Exception):
    """A check of the join that failed: its name and the numbers it compared."""

    def __init__(self, check: str, **numbers):
        super().__init__(check)
        self.record = {"check": check, **numbers}


def host_join(run: dict) -> dict | None:
    """The join's host part, computed once a run (kept in `run`): the traced
    steps and batches, with the spans' metrics, or None where a check of the
    spans against the trace's host-side events breaks it."""
    if "span_host" not in run:
        try:
            run["span_host"] = _host(run)
        except Broken as e:
            run["span_host"], run["span_join_broken"] = None, e.record
    return run["span_host"]


def join(run: dict) -> dict | None:
    """The whole join of the run's trace and the program's spans, computed
    once a run (kept in `run`): {"metrics": {name: value or None}, "clock":
    the offsets checked}, or None where it is broken, with the check that
    broke it in `run["span_join_broken"]`."""
    if "span_join" not in run:
        host = host_join(run)
        run["span_join"] = None
        if host is not None:
            try:
                run["span_join"] = _device(host)
            except Broken as e:
                run["span_join_broken"] = e.record
    return run["span_join"]


def summary(run: dict) -> dict:
    """The result line's account of the join: where it held, the clock
    figures it checked; where it broke, whether its host part held, and the
    check that broke it with its numbers."""
    joined = join(run)
    if joined is None:
        return {"held": False, "host_held": run["span_host"] is not None, **run["span_join_broken"]}
    c = joined["clock"]
    return {"held": True, "host_held": True, "steps": joined["steps"], "drift_ppm": c["drift_ppm"],
            "return_after_copy_us": [min(c["return_after_copy_us"]), max(c["return_after_copy_us"])],
            "span_end_after_copy_us": [min(c["span_end_after_copy_us"]), max(c["span_end_after_copy_us"])],
            "first_start_after_us": min(c["first_start_after_us"]), "entry_launch_us": min(c["entry_launch_us"])}


def _host(run: dict) -> dict:
    """The checks of the spans against the markers' launches, the copies'
    launches and the runtime's synchronize calls, all on the host's clock."""
    path = run.get("trace_path")
    if not path:
        raise Broken("no_trace")
    rec = program_records()
    if rec is None:
        raise Broken("no_program_spans")
    trace = load_trace(path)
    if trace is None:
        raise Broken("no_trace_base")
    device, launches = trace["device"], trace["launches"]
    markers = [e for e in device if MARKER in e["name"]]
    if len(markers) < 2 or len(markers) % 2:
        raise Broken("markers_unpaired", markers=len(markers))
    marker_launch = [launches.get(m["corr"]) for m in markers]
    threads = {x[0] for x in marker_launch if x is not None}
    if None in marker_launch or len(threads) != 1:
        raise Broken("marker_launches", unlaunched=marker_launch.count(None), threads=len(threads))
    main_tid = marker_launch[0][0]
    entry = [ts for _, ts in marker_launch]

    def us(ns: int) -> float:
        return (ns - trace["base_ns"]) / 1000.0

    spans = [(s, us(s.start_ns), us(s.end_ns)) for s in rec["spans"]]
    steps = sorted((x for x in spans if x[0].name == "step" and entry[0] < x[1] and x[2] < entry[-1]),
                   key=lambda x: x[1])
    n = len(steps)
    if n != len(markers) // 2 or n != run.get("traced_steps"):
        raise Broken("step_count", steps=n, marker_pairs=len(markers) // 2, traced_steps=run.get("traced_steps"))
    for k, (_, a, b) in enumerate(steps):
        if not entry[2 * k] <= a < b <= entry[2 * k + 1]:
            raise Broken("step_inside_markers", step=k, open_after_entry_us=a - entry[2 * k],
                         close_before_exit_us=entry[2 * k + 1] - b)
    ids = [s.id for s, _, _ in steps]
    by_id: dict = {i: [] for i in ids}
    for x in spans:
        if x[0].id in by_id:
            by_id[x[0].id].append(x)
    # a batch's first span is its producer's `producer.item`; none may have been pushed out of the ring
    firsts = [min((a for s, a, _ in by_id[i] if s.name == "producer.item"), default=None) for i in ids]
    if None in firsts:
        raise Broken("producer_item", missing=firsts.count(None), dropped=rec["dropped"])
    if rec["dropped"] and spans and spans[0][2] >= min(firsts):
        raise Broken("spans_dropped", dropped=rec["dropped"], oldest_end_after_first_item_us=spans[0][2] - min(firsts))

    # device events the main thread launched, by launch time, and those of each traced step
    main = sorted(((launches[e["corr"]][1], e) for e in device
                   if MARKER not in e["name"] and launches.get(e["corr"], (None,))[0] == main_tid),
                  key=lambda x: x[0])
    main_ts = [ts for ts, _ in main]
    launched = [main[bisect.bisect_right(main_ts, entry[2 * k]):bisect.bisect_left(main_ts, entry[2 * k + 1])]
                for k in range(n)]
    if not all(launched):
        raise Broken("step_launches", empty_steps=sum(not x for x in launched))
    # each sync span, the copy it waited for, and the runtime's synchronize call on it
    main_syncs = [(a, b) for tid, a, b in trace["syncs"] if tid == main_tid]
    waits = []
    for k, ((step, _, _), own) in enumerate(zip(steps, launched)):
        for s, start, end in by_id[step.id]:
            if s.name != "step.sync":
                continue
            before = [(ts, e) for ts, e in own if ts < end]
            if not before:
                raise Broken("sync_copy", step=k)
            ts, copy = max(before, key=lambda x: x[1]["end"])
            call = next(((a, b) for a, b in main_syncs if ts <= a < end), None)
            if call is None:
                raise Broken("sync_call", step=k, copy_launch_after_span_us=ts - start, span_us=end - start)
            if not start <= ts <= call[0] <= call[1] <= end:
                raise Broken("sync_inside_span", step=k, copy_launch_after_span_us=ts - start,
                             call_after_copy_launch_us=call[0] - ts, return_before_span_end_us=end - call[1])
            waits.append((end, copy, call[1]))
    if not waits:
        raise Broken("sync_spans", steps=n)

    def spans_of(name: str) -> list[tuple]:
        return [x for i in ids for x in by_id[i] if x[0].name == name]

    metrics = {m: sum(b - a for _, a, b in spans_of(name)) / 1000.0 / n for m, name in HOST_SPANS.items()}
    pose = [i for i in ids if any(s.name == "producer.pose_batch" for s, _, _ in by_id[i])]
    sdf = [b - a for i in pose for s, a, b in by_id[i] if s.name == "mesh.sdf"]
    metrics["mesh_sdf_ms"] = sum(sdf) / 1000.0 / len(pose) if pose else None
    return {"metrics": metrics, "steps": n, "ids": ids, "device": device, "markers": markers, "main": main,
            "main_ts": main_ts, "entry": entry, "step_spans": steps, "launched": launched, "waits": waits,
            "spans_of": spans_of}


def _device(host: dict) -> dict:
    """The checks of the card's clock against the host's, its drift taken
    out, and the metrics read from the device events."""
    device, markers, main, main_ts = host["device"], host["markers"], host["main"], host["main_ts"]
    steps, launched, waits, entry, n = host["step_spans"], host["launched"], host["waits"], host["entry"], host["steps"]
    anchors = [(back, back - copy["end"]) for _, copy, back in waits]
    rate = drift_rate(anchors)
    if abs(rate) > MAX_DRIFT:
        raise Broken("drift", drift_ppm=rate * 1e6, max_ppm=MAX_DRIFT * 1e6)
    ref = anchors[0][0]
    for e in device:
        e["start"] += rate * (e["start"] - ref)
        e["end"] += rate * (e["end"] - ref)

    clock = {"drift_ppm": rate * 1e6, "return_after_copy_us": [back - copy["end"] for _, copy, back in waits],
             "span_end_after_copy_us": [end - copy["end"] for end, copy, _ in waits],
             "first_start_after_us": [min(e["start"] for _, e in own) - a for (_, a, _), own in zip(steps, launched)],
             "entry_launch_us": [a - entry[2 * k] for k, (_, a, _) in enumerate(steps)]}
    back = clock["return_after_copy_us"]
    if not all(0.0 <= x <= SYNC_SLACK_US for x in back):
        raise Broken("sync_return", return_after_copy_us=[min(back), max(back)], slack_us=SYNC_SLACK_US,
                     drift_ppm=rate * 1e6)
    if min(clock["first_start_after_us"]) < 0:
        raise Broken("start_before_step", first_start_after_us=min(clock["first_start_after_us"]),
                     drift_ppm=rate * 1e6)
    t0, t1 = markers[0]["start"], markers[-1]["end"]
    work = [e for e in device if MARKER not in e["name"] and e["start"] >= t0 and e["end"] <= t1]
    spans_of = host["spans_of"]
    metrics = dict(host["metrics"])
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
    return {"metrics": metrics, "clock": clock, "steps": n, "ids": host["ids"]}


def host_metric(run: dict, name: str):
    """One metric of the spans alone, or None where the join's host part is broken."""
    host = host_join(run)
    return None if host is None else host["metrics"][name]


def metric(run: dict, name: str):
    """One metric of the whole join, or None where it is broken."""
    joined = join(run)
    return None if joined is None else joined["metrics"][name]
