"""CPU tests of the yardstick's arithmetic over every model option that the
renderer builds, of the reference's pretraining under every `cond`, of a
tri-plane pyramid through a whole run, and of the span join's account of
why it broke.

    python -m pytest benchmark/test_yardstick.py -q     # about a minute

No JAX here. The independent counts sum in x out over the weight tensors of
the reference's own modules (`benchmark/reference/`), built at tiny widths.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time
from fractions import Fraction
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, kernels, run, spans
from benchmark.reference import nn1 as nn1_ref
from benchmark.reference import smpl_init
from benchmark.reference.config import Config
from benchmark.reference.networks import COND_DIMS, ImplicitNet
from benchmark.reference.renderer import MultiplyRenderer
from benchmark.test_benchmark_harness import SEED, tiny
from multiply_tpu_torch.utils.profiling import SpanRecord

ROOT = run.ROOT
H100 = "NVIDIA H100 80GB HBM3"


def config(name: str) -> dict:
    return harness.load_yaml(os.path.join(ROOT, "benchmark", "configs", f"{name}.yaml"))


def with_options(model: dict, options: dict) -> dict:
    """`model` with `options` set: dotted keys into its groups."""
    m = copy.deepcopy(model)
    for key, value in options.items():
        harness.set_dotted(m, key, value)
    return m


def weight_macs(module) -> int:
    """in x out summed over the module's dense weights (..., out, in)."""
    return sum(w.shape[-1] * w.shape[-2] for name, w in module.named_parameters()
               if name.endswith("weight") and "lin_pose" not in name and "lin_id" not in name)


def lookup_macs(triplane) -> int:
    """4 multiply-adds a channel of each plane of each level: (P, 3, C, R, R) planes."""
    return sum(kernels.LOOKUP_MACS * p.shape[-4] * p.shape[-3] for name, p in triplane.named_parameters()
               if name.startswith("planes"))


def independent_point_macs(r: MultiplyRenderer) -> int:
    """A foreground SDF evaluation's multiply-adds a point, from the built modules."""
    macs = weight_macs(r.fg_implicit)
    if r.triplane is not None:
        macs += lookup_macs(r.triplane) + (weight_macs(r.triplane) if r.multi_triplane else 0)
    if r.offset_head is not None:
        macs += weight_macs(r.offset_head)
    return macs


OPTION_SETS = {
    "smpl": {},
    "frame": {"implicit_network.cond": "frame"},
    "smpl_id": {"implicit_network.cond": "smpl_id"},
    "none": {"implicit_network.cond": "none"},
    "smpl_tri": {"implicit_network.cond": "smpl_tri", "implicit_network.triplane_resolution": 8},
    "smpl_tri_pyramid": {"implicit_network.cond": "smpl_tri", "implicit_network.multi_triplane": True,
                         "implicit_network.triplane_res": [8, 4]},
    "smpl_tri_pyramid_default_levels": {"implicit_network.cond": "smpl_tri",
                                        "implicit_network.multi_triplane": True},
    "person_encoder": {"use_person_encoder": True},
    "person_encoder_tri": {"use_person_encoder": True, "implicit_network.cond": "smpl_tri",
                           "implicit_network.multi_triplane": True, "implicit_network.triplane_res": [4]},
    "offset_head": {"implicit_network.offset_head": True},
    "offset_head_tri": {"implicit_network.offset_head": True, "implicit_network.cond": "smpl_tri",
                        "implicit_network.multi_triplane": True, "implicit_network.triplane_res": [8, 4]},
    "beta_encoder": {"implicit_network.beta_encoding": True},
    "idr": {"rendering_network.mode": "idr", "rendering_network.multires_view": 2},
    "nerf": {"rendering_network.mode": "nerf"},
    "pose_id_no_view": {"rendering_network.mode": "pose_id_no_view"},
    "fast_preset": {"sampler_bf16": True, "composite_matmul": False, "bbox_ray_range": True},
    "sort_composite": {"composite_matmul": False},
    "loss_terms": {"loss.smpl_surface_weight": 0.1, "loss.zero_pose_weight": 0.1,
                   "implicit_network.beta_encoding": True},
}


@pytest.mark.parametrize("options", OPTION_SETS.values(), ids=OPTION_SETS.keys())
def test_step_flops_counts_what_the_modules_hold(options):
    """Per point: the foreground SDF evaluation and both rendering nets; per
    person and call: the beta encoder; each as in x out over the reference's
    modules built with the option set at tiny widths."""
    model = with_options(tiny(config("taichi01"))["model"], options)
    r = MultiplyRenderer(Config(model), 2, 6, generator=torch.Generator().manual_seed(0), device="cpu")
    assert kernels.foreground_point_macs(model) == independent_point_macs(r)
    dim_frame = int(model["dim_frame_encoding"])
    assert kernels.rendering_macs(model["rendering_network"], dim_frame) == weight_macs(r.fg_render)
    assert kernels.rendering_macs(model["bg_rendering_network"], dim_frame) == weight_macs(r.bg_render)
    beta = weight_macs(r.beta_encoder) if r.beta_encoder is not None else 0
    assert kernels.beta_macs(model) == beta
    flops = kernels.step_flops(model, 2, 40, 386)
    assert flops["total"] == sum(v for k, v in flops.items() if k != "total") > 0
    assert (flops["beta_encoder"] > 0) == (beta > 0)
    on = "loss.smpl_surface_weight" in options  # the SMPL-surface and zero-pose terms' own evaluations
    assert (flops["smpl_surface"] > 0) == (flops["zero_pose"] > 0) == on


def test_step_flops_of_the_cells_are_the_parents_to_the_bit():
    assert kernels.step_flops(config("taichi01")["model"], 2, 512, 6890)["total"] == 1_626_789_433_344
    assert kernels.step_flops(config("mmm3")["model"], 3, 512, 6890)["total"] == 2_411_998_427_136


def test_step_flops_of_the_pyramid_at_published_widths():
    """taichi01's widths with the pyramid (four levels of 64 channels): an SDF
    evaluation 1.681 MFLOP against 1.084, the step 2.378 TFLOP; the modules
    built at these widths hold the same per-point count."""
    model = with_options(config("taichi01")["model"], OPTION_SETS["smpl_tri_pyramid_default_levels"])
    r = MultiplyRenderer(Config(model), 2, 1, generator=torch.Generator().manual_seed(0), device="cpu")
    assert kernels.foreground_point_macs(model) == independent_point_macs(r) == 840_448
    assert sum(p.numel() for n, p in r.triplane.named_parameters() if n.startswith("planes")) == 2 * 4_177_920
    assert 2 * kernels.foreground_point_macs(config("taichi01")["model"]) == 1_084_416
    assert kernels.step_flops(model, 2, 512, 6890)["total"] == pytest.approx(2.378e12, rel=5e-3)


@pytest.mark.parametrize("key, value", [("implicit_network.cond", "smpl_x"), ("rendering_network.mode", "ngp"),
                                        ("bg_implicit_network.cond", "smpl_x")])
def test_step_flops_names_an_option_it_does_not_know(key, value):
    model = with_options(config("taichi01")["model"], {key: value})
    with pytest.raises(ValueError, match=value):
        kernels.step_flops(model, 2, 512, 6890)


def test_triplane_bound_of_the_pyramid():
    """P = 2, N = 99,328 points, 64 channels at 128/64/32/16: 610 MB of
    features written, 33 MB of planes read; bound by its bytes at 0.1929 ms."""
    t, by = kernels.triplane_bound(2, 99_328, 64, (128, 64, 32, 16), kernels.peaks(H100))
    assert by == "bytes" and round(t * 1e3, 4) == 0.1929
    t1, _ = kernels.triplane_bound(2, 99_328, 64, (128,), kernels.peaks(H100))
    assert t1 < t / 3


def round_f32(x: Fraction) -> float:
    """A rational rounded to the nearest float32, ties to even."""
    if x == 0:
        return 0.0
    mag = abs(x)
    e = math.floor(math.log2(mag.numerator) - math.log2(mag.denominator))
    e += (Fraction(2) ** (e + 1) <= mag) - (Fraction(2) ** e > mag)
    q = mag / Fraction(2) ** (max(e, -126) - 23)
    n, r = divmod(q.numerator, q.denominator)
    n += 2 * r > q.denominator or (2 * r == q.denominator and n % 2 == 1)
    return math.copysign(float(n * Fraction(2) ** (max(e, -126) - 23)), x)


# (a, b, c) whose float64 sum falls on the midpoint of two float32 values while the exact sum does not
MIDPOINTS = [(1 + 2**-23, 1 - 2**-23, 1 + 2**-23, 2**-24), (1 + 2**-23, 1 + 2**-23, 1 + 2**-23, 2**-24),
             (1 - 2**-23, 1 - 2**-23, 1.0, 2**-24), (1 + 2**-23, 1 - 2**-23, -(1 + 2**-23), 2**-24)]


def test_the_references_fused_multiply_add_rounds_once():
    """`fma_f32` is a * b + c rounded once, against a rational count: on random
    operands over 2^-30 to 2^4, and where rounding the float64 sum again would
    go wrong."""
    g = torch.Generator().manual_seed(0)
    n = 4000
    a, b, c = (torch.randn(n, generator=g) * torch.exp2(torch.randint(-30, 5, (n,), generator=g).float())
               for _ in range(3))
    mid = [(x * s**0.5, y * s**0.5 * sign, z) for x, y, z, s in MIDPOINTS for sign in (1.0, -1.0)]
    a, b, c = (torch.cat([t, torch.tensor([m[i] for m in mid])]).float() for i, t in enumerate((a, b, c)))
    exact = [round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
             for x, y, z in zip(a.tolist(), b.tolist(), c.tolist())]
    assert nn1_ref.fma_f32(a, b, c).tolist() == exact
    twice = (a.double() * b.double() + c.double()).float().tolist()
    assert twice != exact  # the midpoints are cases that rounding twice gets wrong


def test_the_references_nn1_rounds_as_the_path_it_judges(monkeypatch):
    """On the CPU the distance is the plain sum, as the port's CPU path has it;
    on a CUDA tensor the fused form of `csrc/nn1.cu` (taken here on CPU tensors
    that claim to be CUDA ones): the same nearest vertex on well-separated
    points, each distance exactly the kernel's arithmetic."""
    g = torch.Generator().manual_seed(1)
    refs = torch.randn((2, 50, 3), generator=g)
    query = refs[:, torch.randint(0, 50, (300,), generator=g)] + torch.randn((2, 300, 3), generator=g) * 0.05
    d2_plain, idx_plain = nn1_ref.nn1(query, refs)
    diff = query[:, :, None] - refs[:, None]
    assert torch.equal(d2_plain[..., 0], ((diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2).min(-1).values)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    d2_fused, idx_fused = nn1_ref.nn1(query, refs)
    dx, dy, dz = diff.unbind(-1)
    fused = nn1_ref.fma_f32(dz, dz, nn1_ref.fma_f32(dy, dy, dx * dx))
    assert torch.equal(d2_fused[..., 0], fused.min(-1).values)
    assert torch.equal(idx_fused, idx_plain) and torch.equal(idx_fused[..., 0], fused.argmin(-1))


@pytest.mark.parametrize("cond", sorted(COND_DIMS))
def test_the_reference_pretraining_takes_every_cond(cond):
    """`smpl_init` of the reference under every `cond`, `smpl_tri` with its 133
    zeros: two Adam steps on a small closed body that change the net."""
    net = ImplicitNet(dims=(16, 16), feature_vector_size=4, skip_in=(), multires=2, cond=cond,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    assert net.lins[0].weight.shape[-1] == kernels.embed_dim(2, 3) + COND_DIMS[cond]
    verts = torch.tensor([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]) * 0.3
    faces = torch.tensor([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    server = SimpleNamespace(verts_c=verts, model=SimpleNamespace(faces=faces))
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    after = smpl_init.pretrain(net, server, steps=2, batch=64, pool=256)
    assert after.keys() == before.keys()
    assert all(torch.isfinite(v).all() for v in after.values())
    assert any(not torch.equal(after[k], before[k]) for k in before)


def test_a_tiny_pyramid_runs_through_a_whole_run_and_is_correct(monkeypatch):
    """`cond: smpl_tri` with the pyramid (levels 8 and 4, `smpl_init` off) at
    test widths, from set-up to the check, on the CPU: correct, with the
    pyramid's planes among the parameters that the check compared (the
    wrapper of `run_cell` only keeps the records it returns)."""
    parts = run.cell_parts

    def pyramid_parts(bench, name):
        cell, entry, conf, traffic = parts(bench, name)
        conf = tiny(conf)
        conf["model"]["implicit_network"].update(cond="smpl_tri", multi_triplane=True, triplane_res=[8, 4])
        conf["model"]["smpl_init"] = False
        return cell, entry, conf, traffic

    monkeypatch.setattr(run, "cell_parts", pyramid_parts)
    seen = {}
    run_cell = harness.run_cell

    def keep(*args, **kwargs):
        seen.update(run_cell(*args, **kwargs))
        return seen

    monkeypatch.setattr(harness, "run_cell", keep)
    res = run.measure(run.load_bench(), "taichi01.joint", SEED, 1.0, False, device="cpu",
                      t_begin=time.perf_counter())
    names = set(seen["prog"]["start"]["params0"])
    assert any("planes_8" in n for n in names) and any("planes_4" in n for n in names)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and "span_join" not in res  # an untraced run


# ---------------------------------------------------------------------------
# the span join's account of why it broke, on a hand-made trace
# ---------------------------------------------------------------------------

BASE_NS = 1_790_000_000_000_000_000
MAIN, AUTOGRAD = 111, 222
SPIN = "void spin_kernel(long)"
COPY = "Memcpy DtoH (Device -> Pinned)"


class Timeline:
    """The hand-made trace of `tests/test_torch_tracing.py`: a chrome trace and
    program spans with known numbers, in microseconds from the trace's base.
    Two traced steps, ids 40 and 41, `step_us` apart; in each a forward with
    two kernels, a backward on autograd's thread, a sync on a copy, an update
    and a second sync."""

    def __init__(self, step_us: float = 1000.0):
        self.events, self.spans, self.corr = [], [], 0
        for k, ident in enumerate((40, 41)):
            o = step_us * k
            self.span("producer.item", o - 300, o - 200, None, ident, tid=2)
            if k == 1:
                self.span("producer.pose_batch", o - 200, o - 50, None, ident, tid=2)
                self.span("mesh.sdf", o - 190, o - 140, "mesh.extract", ident, tid=2)
            self.span("loop.queue_get", o - 10, o - 1, "epoch", ident)
            self.launch(MAIN, o, o + 1, o + 2, SPIN)
            self.span("step", o + 5, o + 500, "epoch", ident)
            self.span("step.forward", o + 10, o + 100, "step", ident)
            self.span("render.sampler", o + 15, o + 55, "step.forward", ident)
            self.launch(MAIN, o + 20, o + 25, o + 60)
            self.launch(MAIN, o + 50, o + 60, o + 90)
            self.span("step.backward", o + 100, o + 200, "step", ident)
            self.launch(AUTOGRAD, o + 110, o + 112, o + 190)
            self.span("step.sync", o + 200, o + 260, "step", ident)
            self.launch(MAIN, o + 205, o + 240, o + 250, COPY, "gpu_memcpy")
            self.synchronize(MAIN, o + 207, o + 253)
            self.span("step.update", o + 260, o + 400, "step", ident)
            self.launch(MAIN, o + 270, o + 280, o + 300)
            self.span("step.sync", o + 400, o + 430, "step", ident)
            self.launch(MAIN, o + 405, o + 420, o + 425, COPY, "gpu_memcpy")
            self.synchronize(MAIN, o + 407, o + 428)
            self.launch(MAIN, o + 501, o + 502, o + 503, SPIN)
        self.dropped, self.base_ns, self.drift = 0, BASE_NS, 0.0

    def launch(self, tid, ts, start, end, name="kernel_a", cat="kernel"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts,
                            "dur": 2.0, "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": start, "dur": end - start,
                            "args": {"correlation": self.corr}})

    def synchronize(self, tid, ts, end):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "tid": tid,
                            "ts": ts, "dur": end - ts, "args": {"correlation": self.corr}})

    def span(self, name, a, b, parent, ident, tid=1):
        self.spans.append(SpanRecord(name, tid, BASE_NS + int(a * 1000), BASE_NS + int(b * 1000), parent, ident))

    def device(self, name=None):
        return [e for e in self.events if e["cat"] in ("kernel", "gpu_memcpy") and name in (None, e["name"])]

    def run(self, path, traced_steps=2) -> dict:
        events = [dict(e, ts=e["ts"] * (1.0 - self.drift)) if e["cat"] in ("kernel", "gpu_memcpy") else e
                  for e in self.events]
        with open(path, "w") as f:
            json.dump({"baseTimeNanoseconds": self.base_ns, "traceEvents": events}, f)
        return {"trace_path": str(path), "traced_steps": traced_steps}


def _span_end(tl, name, ident, nth, end_us):
    """The `nth` span `name` of batch `ident` closes at `end_us`."""
    i = [i for i, s in enumerate(tl.spans) if s.name == name and s.id == ident][nth]
    tl.spans[i] = tl.spans[i]._replace(end_ns=BASE_NS + int(end_us * 1000))


def _late_sync_return(tl):
    """Step 40's second synchronize returns 250 us after its copy, inside a longer sync span."""
    call = [e for e in tl.events if e["name"] == "cudaStreamSynchronize"][1]
    call["dur"] = 425.0 + 250.0 - call["ts"]
    _span_end(tl, "step.sync", 40, 1, 680.0)


def _drop_step_41_work(tl):
    keep = {e["args"]["correlation"] for e in tl.events if e["cat"] == "cuda_runtime"
            and not (1000 < e["ts"] < 1501 and e["tid"] == MAIN)}  # step 41's, at the default spacing
    tl.events = [e for e in tl.events if e["args"]["correlation"] in keep or e["name"] == SPIN]


BREAKS = {
    "no_trace": lambda tl, ctx: ctx.update(path=None),
    "no_program_spans": lambda tl, ctx: ctx.update(records=None),
    "no_trace_base": lambda tl, ctx: setattr(tl, "base_ns", None),
    "markers_unpaired": lambda tl, ctx: tl.events.remove(tl.device(SPIN)[-1]),
    "marker_launches": lambda tl, ctx: tl.events[0].update(tid=AUTOGRAD),
    "step_count": lambda tl, ctx: ctx.update(traced_steps=3),
    "step_inside_markers": lambda tl, ctx: _span_end(tl, "step", 40, 0, 600.0),
    "producer_item": lambda tl, ctx: tl.spans.pop(next(i for i, s in enumerate(tl.spans)
                                                       if s.name == "producer.item" and s.id == 41)),
    "spans_dropped": lambda tl, ctx: setattr(tl, "dropped", 3),
    "step_launches": lambda tl, ctx: _drop_step_41_work(tl),
    "sync_copy": lambda tl, ctx: tl.span("step.sync", 6, 8, "step", 40),
    "sync_call": lambda tl, ctx: tl.events.remove(next(e for e in tl.events if e["name"] == "cudaStreamSynchronize")),
    "sync_inside_span": lambda tl, ctx: _span_end(tl, "step.sync", 40, 0, 251.0),
    "drift": lambda tl, ctx: setattr(tl, "drift", 5e-3),
    "sync_return": lambda tl, ctx: _late_sync_return(tl),
    "start_before_step": lambda tl, ctx: tl.device("kernel_a")[0].update(ts=3.0),
}


DEVICE_CHECKS = ("drift", "sync_return", "start_before_step")


def _join_of(tmp_path, monkeypatch, brk=None):
    # steps 0.4 s apart where one late return should not read as a drift of the card's clock
    tl, ctx = Timeline(400_000.0 if brk == "sync_return" else 1000.0), {}
    if brk is not None:
        BREAKS[brk](tl, ctx)
    records = ctx.get("records", {"spans": tl.spans, "counters": [], "dropped": tl.dropped})
    monkeypatch.setattr(spans, "program_records", lambda: records)
    r = tl.run(tmp_path / "trace.json", ctx.get("traced_steps", 2))
    if "path" in ctx:
        r["trace_path"] = ctx["path"]
    return r


def test_the_hand_made_join_holds_and_says_on_what_clock(tmp_path, monkeypatch):
    r = _join_of(tmp_path, monkeypatch)
    got = spans.summary(r)
    assert got == {"held": True, "host_held": True, "steps": 2, "drift_ppm": 0.0, "return_after_copy_us": [3.0, 3.0],
                   "span_end_after_copy_us": [5.0, 10.0], "first_start_after_us": 20.0, "entry_launch_us": 5.0}
    assert "span_join_broken" not in r and spans.metric(r, "update_launches") == 1.0
    assert spans.host_metric(r, "sync_wait_ms") == spans.metric(r, "sync_wait_ms") == pytest.approx(0.09)


@pytest.mark.parametrize("brk", BREAKS)
def test_each_break_of_the_join_names_its_own_check(tmp_path, monkeypatch, brk):
    r = _join_of(tmp_path, monkeypatch, brk)
    assert spans.join(r) is None and spans.metric(r, "idle_launch_ms") is None
    on_the_card = brk in DEVICE_CHECKS  # the spans' own metrics stand without the card's clock
    assert (spans.host_metric(r, "sync_wait_ms") is not None) == on_the_card
    assert (spans.host_metric(r, "mesh_sdf_ms") == pytest.approx(0.05)) == on_the_card
    got = spans.summary(r)
    assert got["held"] is False and got["host_held"] is on_the_card and got["check"] == brk, got
    assert all(isinstance(v, (int, float, list, str)) and v == v for v in got.values() if v is not None)
    json.dumps(got)
    if brk == "drift":
        assert got["drift_ppm"] == pytest.approx(5000, rel=1e-3) and got["max_ppm"] == 1000
    if brk == "sync_return":
        assert got["return_after_copy_us"][1] > 240 and got["slack_us"] == spans.SYNC_SLACK_US
    if brk == "step_count":
        assert (got["steps"], got["marker_pairs"], got["traced_steps"]) == (2, 2, 3)
    if brk == "spans_dropped":
        assert got["dropped"] == 3


def test_a_traced_result_line_carries_the_join_before_the_checks(monkeypatch):
    """The traced line's `span_join` (on the CPU: no trace, so the join breaks
    at its first check) stands just before `checks`, which stays last."""
    monkeypatch.setattr(run, "cell_parts", lambda bench, name, parts=run.cell_parts: (
        lambda c: (c[0], c[1], tiny(c[2]), c[3]))(parts(bench, name)))
    res = run.measure(run.load_bench(), "taichi01.joint", SEED + 1, 0.5, True, device="cpu",
                      t_begin=time.perf_counter())
    assert list(res)[-2:] == ["span_join", "checks"]
    assert res["span_join"] == {"held": False, "host_held": False, "check": "no_trace"}
    assert math.isfinite(res["checks"]["loss_gap"]["value"])
