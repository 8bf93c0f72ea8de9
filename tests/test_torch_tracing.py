"""The port's spans and counters (`multiply_tpu_torch/utils/profiling.py`) and
the benchmark's join of them with a device trace (`benchmark/spans.py`).

No JAX here. The recorder's own rules on a `Recorder` of the test's; the
program's spans on the module-wide recorder, reset by the `program` fixture,
over one joint and one pose-only `train_epoch` of the tiny scene that
`test_torch_trainer.py` builds (2 frames, 2 persons, 20x24 pixels, tiny
widths); the join and each new reader on a hand-made chrome trace and spans
whose numbers are known.
"""

import json
import threading

import pytest

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
from benchmark import run as bench_run
from benchmark import spans as bench_spans
from multiply_tpu_torch.cli import train as cli_train
from multiply_tpu_torch.engine.train import MODE_JOINT, MODE_POSE_ONLY
from multiply_tpu_torch.utils import profiling
from multiply_tpu_torch.utils.profiling import Recorder, SpanRecord
from test_torch_fit import argv

NEW_METRICS = ("queue_wait_ms", "forward_host_ms", "backward_host_ms", "sync_wait_ms", "update_host_ms",
               "idle_launch_ms", "mesh_sdf_ms", "update_launches", "sampler_device_ms")


@pytest.fixture
def program():
    """The module-wide recorder, emptied before and after the test."""
    profiling.reset()
    yield profiling
    profiling.reset()


def test_spans_nest_on_one_thread_and_close_on_exceptions():
    rec = Recorder()
    with rec.span("a"):
        with rec.span("b"):
            with rec.span("c"):
                pass
        with rec.span("d"):
            pass
        seen = {}
        t = threading.Thread(target=lambda: seen.update(s=rec.span("other").__enter__().parent))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen["s"] is None  # another thread's stack is its own
    with pytest.raises(ValueError):
        with rec.span("raised"):
            raise ValueError("leaves the span")
    with rec.span("after"):
        pass
    spans = rec.records()["spans"]
    assert [s.name for s in spans] == ["c", "b", "d", "a", "raised", "after"]
    parents = {s.name: s.parent for s in spans}
    assert parents == {"c": "b", "b": "a", "d": "a", "a": None, "raised": None, "after": None}
    by = {s.name: s for s in spans}
    for child, parent in (("c", "b"), ("b", "a"), ("d", "a")):
        assert by[parent].start_ns <= by[child].start_ns <= by[child].end_ns <= by[parent].end_ns
    assert by["b"].end_ns <= by["d"].start_ns
    assert len({s.tid for s in spans}) == 1 and rec.records()["dropped"] == 0


def test_counters_add_under_each_threads_id():
    rec = Recorder()
    rec.count("x")  # no id yet
    rec.set_id(7)
    rec.count("x")
    rec.count("x", 2)
    rec.count("y", 5)

    def other():
        rec.set_id(8)
        rec.count("x", 10)
        with rec.span("s"):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    rec.count("x")  # still id 7 on this thread
    with rec.span("s"):
        pass
    got = {(name, ident): n for name, ident, n in rec.records()["counters"]}
    assert got == {("x", None): 1, ("x", 7): 4, ("y", 7): 5, ("x", 8): 10}
    assert sorted(s.id for s in rec.records()["spans"]) == [7, 8]
    rec.reset()
    assert rec.records() == {"spans": [], "counters": [], "dropped": 0}


def test_the_ring_keeps_the_newest_and_counts_the_dropped():
    ring = profiling.RING
    assert ring >= 2**17
    rec = Recorder()
    for i in range(ring + 2):
        with rec.span(f"s{i}"):
            pass
    out = rec.records()
    assert len(out["spans"]) == ring and out["dropped"] == 2
    assert (out["spans"][0].name, out["spans"][-1].name) == ("s2", f"s{ring + 1}")
    for i in range(ring + 3):
        rec.set_id(i)
        rec.count("c")
    out = rec.records()
    assert len(out["counters"]) == ring and out["dropped"] == 5
    assert (out["counters"][0][1], out["counters"][-1][1]) == (3, ring + 2)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """The port's trainer on the tiny scene, with the epoch-0 mask and SAM
    stages made, so that a pose epoch's frames have SAM masks; pose epochs
    on the code-default schedule (`depth_end` off: 200, 210, ...)."""
    run_dir = tmp_path_factory.mktemp("run")
    tr, _, _ = cli_train.build_trainer(cli_train.parse_args(argv(run_dir, sets=("model.depth_end=false",))))
    tr.instance_mask_stage(epoch=0)
    tr.sam_stage(epoch=0)
    return tr


STEP_CHILDREN = {"step.forward", "step.backward", "step.finite", "step.sync", "step.update"}


@pytest.mark.parametrize("epoch, mode", [(1, MODE_JOINT), (200, MODE_POSE_ONLY)], ids=["joint", "pose_only"])
def test_a_batch_shares_its_id_from_the_producer_to_the_step(program, trainer, epoch, mode):
    trainer.epoch = epoch
    out = trainer.train_epoch()
    n = trainer.num_frames
    assert out["n_pose_only" if mode == MODE_POSE_ONLY else "n_joint"] == n
    rec = program.records()
    spans, counters = rec["spans"], {(k, i): c for k, i, c in rec["counters"]}
    ids = sorted(s.id for s in spans if s.name == "producer.item")
    assert len(set(ids)) == n and {s.id for s in spans if s.name == "step"} == set(ids) and rec["dropped"] == 0
    assert {i for _, i, _ in rec["counters"]} == set(ids)  # every counter of the epoch under a batch's id

    def named(name, ident):
        return [s for s in spans if s.name == name and s.id == ident]

    main_tid = threading.get_native_id()
    for i in ids:
        (step,) = named("step", i)
        (item,) = named("producer.item", i)
        assert len(named("loop.queue_get", i)) == 1 and len(named("producer.h2d", i)) == 1
        assert step.tid == main_tid and step.parent == "epoch" and item.tid != main_tid
        assert item.end_ns <= step.start_ns
        inside = [s for s in spans if s.id == i and s.parent == "step"]
        assert {s.name for s in inside} == STEP_CHILDREN
        assert all(step.start_ns <= s.start_ns and s.end_ns <= step.end_ns for s in inside)
        assert len(named("step.sync", i)) == 2 and counters[("step.host_waits", i)] == 2
        assert {s.parent for s in named("render.sampler", i) + named("loss.total", i)} == {"step.forward"}
        assert counters[("sampler.points", i)] > 0 and counters[("adam.leaves", i)] > 0
        pose = named("producer.pose_batch", i)
        if mode == MODE_POSE_ONLY:
            assert len(pose) == 1 and [s.parent for s in named("step.pose_losses", i)] == ["step.forward"]
            extracts = named("mesh.extract", i)
            assert len(extracts) == trainer.num_person and {s.parent for s in extracts} == {"producer.pose_batch"}
            sdf = named("mesh.sdf", i)
            assert sdf and {s.parent for s in sdf} == {"mesh.extract"} and {s.tid for s in sdf} == {item.tid}
            assert counters[("mesh.rounds", i)] >= trainer.num_person and counters[("mesh.sdf_points", i)] > 0
        else:
            assert not pose and not named("mesh.sdf", i) and ("mesh.rounds", i) not in counters
    (epoch_span,) = [s for s in spans if s.name == "epoch"]
    assert epoch_span.id is None and epoch_span.parent is None


# ---------------------------------------------------------------------------
# the join, on a hand-made trace
# ---------------------------------------------------------------------------

BASE_NS = 1_790_000_000_000_000_000
MAIN, AUTOGRAD = 111, 222  # the trace's thread ids of the launches
STEP_US = 1000.0


class Timeline:
    """A chrome trace and program spans whose numbers are known, in
    microseconds from the trace's base."""

    def __init__(self):
        self.events, self.spans, self.corr = [], [], 0

    def launch(self, tid, ts, start, end, name="kernel_a", cat="kernel"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": tid,
                            "ts": ts, "dur": 2.0, "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": start,
                            "dur": end - start, "args": {"correlation": self.corr, "stream": 7}})

    def synchronize(self, tid, ts, end):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "pid": 1, "tid": tid,
                            "ts": ts, "dur": end - ts, "args": {"correlation": self.corr}})

    def span(self, name, a, b, parent, ident, tid=1):
        self.spans.append(SpanRecord(name, tid, BASE_NS + int(a * 1000), BASE_NS + int(b * 1000), parent, ident))

    def write(self, path, shift_ns=0, drift=0.0, origin=0.0):
        """The trace with its base moved by `shift_ns`, and the device events'
        clock running `drift` slower than the host's from `origin` (us) on."""
        events = []
        for e in self.events:
            if e["cat"] in ("kernel", "gpu_memcpy"):
                e = dict(e, ts=e["ts"] - drift * (e["ts"] - origin), dur=e["dur"] * (1.0 - drift))
            events.append(e)
        with open(path, "w") as f:
            json.dump({"baseTimeNanoseconds": BASE_NS + shift_ns, "traceEvents": events}, f)
        return str(path)


def hand_made(pose_step: int = 1, step_us: float = STEP_US) -> Timeline:
    """Two traced steps, ids 40 and 41, `step_us` apart. In each (us from the
    step's offset): markers launched at 0 and 501; `step` 5-500; forward
    10-100 with kernels 25-60 and 60-90, launched at 20 and 50 inside
    `render.sampler` 15-55; backward 100-200, autograd's kernel 112-190;
    sync 200-260 on a copy 240-250, whose synchronize returns at 253; update
    260-400 with kernels 280-300 and 360-380 (idle 20 + 60 + 20 inside); sync
    400-430 on a copy 420-425, returned at 428."""
    tl = Timeline()
    for k, ident in enumerate((40, 41)):
        o = k * step_us
        tl.span("producer.item", o - 300, o - 200, None, ident, tid=2)
        if k == pose_step:
            tl.span("producer.pose_batch", o - 200, o - 50, None, ident, tid=2)
            tl.span("mesh.sdf", o - 190, o - 140, "mesh.extract", ident, tid=2)
            tl.span("mesh.sdf", o - 130, o - 100, "mesh.extract", ident, tid=2)
        tl.span("loop.queue_get", o - 10, o - 1, "epoch", ident)
        tl.launch(MAIN, o + 0, o + 1, o + 2, name="void spin_kernel(long)")
        tl.span("step", o + 5, o + 500, "epoch", ident)
        tl.span("step.forward", o + 10, o + 100, "step", ident)
        tl.span("render.sampler", o + 15, o + 55, "step.forward", ident)
        tl.launch(MAIN, o + 20, o + 25, o + 60)
        tl.launch(MAIN, o + 50, o + 60, o + 90)
        tl.span("step.backward", o + 100, o + 200, "step", ident)
        tl.launch(AUTOGRAD, o + 110, o + 112, o + 190)
        tl.span("step.sync", o + 200, o + 260, "step", ident)
        tl.launch(MAIN, o + 205, o + 240, o + 250, name="Memcpy DtoH (Device -> Pinned)", cat="gpu_memcpy")
        tl.synchronize(MAIN, o + 207, o + 253)
        tl.span("step.update", o + 260, o + 400, "step", ident)
        tl.launch(MAIN, o + 270, o + 280, o + 300)
        tl.launch(MAIN, o + 350, o + 360, o + 380)
        tl.span("step.sync", o + 400, o + 430, "step", ident)
        tl.launch(MAIN, o + 405, o + 420, o + 425, name="Memcpy DtoH (Device -> Pinned)", cat="gpu_memcpy")
        tl.synchronize(MAIN, o + 407, o + 428)
        tl.launch(MAIN, o + 501, o + 502, o + 503, name="void spin_kernel(long)")
    tl.span("step", 3 * step_us, 3 * step_us + 400, "epoch", 42)  # past the traced window
    return tl


def read_new(run):
    bench = bench_run.load_bench()
    entries = [m for m in bench_run.metrics_of(bench, "taichi01.pose", True) if m["name"] in NEW_METRICS]
    assert {m["name"] for m in entries} == set(NEW_METRICS)
    return {k: v["value"] for k, v in bench_run.read_metrics(entries, run).items()}


def test_the_join_reads_known_numbers_back(tmp_path, monkeypatch):
    tl = hand_made()
    monkeypatch.setattr(bench_spans, "program_records", lambda: {"spans": tl.spans, "counters": [], "dropped": 0})
    run = {"trace_path": tl.write(tmp_path / "trace.json"), "traced_steps": 2}
    got = read_new(run)
    want = {"queue_wait_ms": 0.009, "forward_host_ms": 0.09, "backward_host_ms": 0.1, "sync_wait_ms": 0.09,
            "update_host_ms": 0.14, "idle_launch_ms": (25 + 22 + 100) / 1000, "mesh_sdf_ms": 0.08,
            "update_launches": 2.0, "sampler_device_ms": (35 + 30) / 1000}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    clock = run["span_join"]["clock"]
    assert clock["drift_ppm"] == 0 and clock["return_after_copy_us"] == [3, 3, 3, 3]
    assert clock["span_end_after_copy_us"] == [10, 5, 10, 5] and clock["first_start_after_us"] == [20, 20]
    assert clock["entry_launch_us"] == [5, 5]


def test_the_join_takes_out_the_cards_clock_drift(tmp_path, monkeypatch):
    """The card's clock 800 ppm slow, steps 0.4 s apart: the second step's
    device events come 320 us early, its kernels before their launches. The
    join fits the drift from the copies' ends against the synchronize calls'
    returns and reads the numbers of an undrifted trace; a drift past
    `MAX_DRIFT` breaks the join."""
    tl = hand_made(step_us=400_000.0)
    monkeypatch.setattr(bench_spans, "program_records", lambda: {"spans": tl.spans, "counters": [], "dropped": 0})
    clean = read_new({"trace_path": tl.write(tmp_path / "clean.json"), "traced_steps": 2})
    run = {"trace_path": tl.write(tmp_path / "drift.json", drift=8e-4, origin=253.0), "traced_steps": 2}
    got = read_new(run)
    assert got.keys() == clean.keys() and len(got) == len(NEW_METRICS)
    for k, v in clean.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k
    assert run["span_join"]["clock"]["drift_ppm"] == pytest.approx(800, rel=1e-3)
    far = tl.write(tmp_path / "far.json", drift=5e-3, origin=253.0)
    assert bench_spans.join({"trace_path": far, "traced_steps": 2}) is None


@pytest.mark.parametrize("shift_us", [-300.0, 300.0, 20.0], ids=["spans_late", "spans_early", "spans_early_20us"])
def test_a_shifted_clock_breaks_the_join(tmp_path, monkeypatch, shift_us):
    """The trace's base moved by `shift_us` moves every span by its negative
    against the trace's events: a span clock late by 300 us opens the step
    after its first kernel starts and its syncs after their copies' launches;
    one early by 300 us, or by 20 us, ends a sync before the synchronize call
    that it holds returns."""
    tl = hand_made()
    monkeypatch.setattr(bench_spans, "program_records", lambda: {"spans": tl.spans, "counters": [], "dropped": 0})
    run = {"trace_path": tl.write(tmp_path / "trace.json", shift_ns=int(shift_us * 1000)), "traced_steps": 2}
    assert bench_spans.join(run) is None and read_new(run) == {}


def test_the_join_refuses_missing_or_dropped_spans(tmp_path, monkeypatch):
    tl = hand_made()
    path = tl.write(tmp_path / "trace.json")
    cases = [
        None,  # a program that records no spans (the parent commit)
        {"spans": tl.spans[1:], "counters": [], "dropped": 1},  # the first batch's producer.item pushed out
        {"spans": [s for s in tl.spans if s.name != "step" or s.id != 41], "counters": [], "dropped": 0},
    ]
    for records in cases:
        monkeypatch.setattr(bench_spans, "program_records", lambda records=records: records)
        assert bench_spans.join({"trace_path": path, "traced_steps": 2}) is None
    older = SpanRecord("producer.item", 2, BASE_NS - 10_000_000, BASE_NS - 9_000_000, None, 39)
    monkeypatch.setattr(bench_spans, "program_records",
                        lambda: {"spans": [older, *tl.spans], "counters": [], "dropped": 5})
    assert bench_spans.join({"trace_path": path, "traced_steps": 2}) is not None  # dropped before batch 40
    assert bench_spans.join({"trace_path": path, "traced_steps": 3}) is None
    assert bench_spans.join({"trace_path": None, "traced_steps": 0}) is None
