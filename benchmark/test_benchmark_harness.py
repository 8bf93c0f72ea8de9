"""CPU tests of the benchmark harness at tiny sizes (the kernels in their
plain forms), and of its arithmetic, readers and refusals.

    python -m pytest benchmark -q          # two to four minutes on a few cores

The card-only test carries the `cuda` marker and skips without a card.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import time

import pytest
import torch

from benchmark import control, harness, kernels, run, traces

ROOT = run.ROOT
CELLS = ("taichi01.joint", "mmm3.joint", "taichi01.pose")
SEED = 3_000_000_019  # past 32 signed bits: the command takes seeds that large
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny(config: dict) -> dict:
    """A cell's configuration at test widths: the same code paths, small."""
    c = copy.deepcopy(config)
    m = c["model"]
    m["implicit_network"].update(dims=[32, 32], skip_in=[], multires=2, feature_vector_size=32)
    m["rendering_network"].update(dims=[32], feature_vector_size=32)
    m["bg_implicit_network"].update(dims=[32, 32], multires=2, feature_vector_size=32)
    m["bg_rendering_network"].update(dims=[16], feature_vector_size=32)
    m["ray_sampler"].update(N_samples=8, N_samples_eval=16, N_samples_extra=4, beta_iters=3, max_total_iters=2,
                            N_samples_inverse_sphere=4)
    m.update(dim_frame_encoding=8, pose_pixel_samples=64, interp_samples=48, mesh_pad_bucket=1024,
             cano_grid_res=8, cano_mesh_res_up=0, smpl_init_steps=20)
    c["dataset"]["train"].update(num_sample=40, end_frame=6)
    c["scene"].update(frames=6, height=40, width=48, focal=38.4, body_verts=386)
    return c


@pytest.fixture(scope="module")
def bench():
    return run.load_bench()


@pytest.fixture
def tiny_cells(monkeypatch):
    """Every cell at test widths."""
    parts = run.cell_parts

    def tiny_parts(bench, name):
        cell, entry, config, traffic = parts(bench, name)
        return cell, entry, tiny(config), traffic

    monkeypatch.setattr(run, "cell_parts", tiny_parts)


def measure(bench, cell):
    return run.measure(bench, cell, SEED, 1.0, False, device="cpu", t_begin=time.perf_counter())


def plant(monkeypatch, fault: str) -> None:
    """One fault in the program, under the harness: the state left as it was
    (`unchanged`), half of each batch's rays left out and the mean taken
    over the rest (`half_batch`), each batch's colours altered where the
    producer makes them (`altered`)."""
    from multiply_tpu_torch.engine.train import TrainStep
    from multiply_tpu_torch.engine.trainer import Trainer

    if fault == "unchanged":
        orig_step = TrainStep.step

        def step(self, ts, batch, noise=None, generator=None, pose_batch=None):
            keep = {k: p.detach().clone() for k, p in ts.params().items()}
            opt = (ts.opt_joint, ts.opt_pose)
            ts, logs = orig_step(self, ts, batch, noise, generator, pose_batch)
            with torch.no_grad():
                for k, p in ts.params().items():
                    p.copy_(keep[k])
            ts.opt_joint, ts.opt_pose = opt
            return ts, logs

        monkeypatch.setattr(TrainStep, "step", step)
    elif fault == "half_batch":
        orig_train_step = Trainer.train_step

        def train_step(self, batch, pose_batch=None):
            half = batch.uv.shape[0] // 2
            cut = copy.copy(batch)
            cut.uv, cut.rgb = batch.uv[:half], batch.rgb[:half]
            cut.sam_mask = None if batch.sam_mask is None else batch.sam_mask[:half]
            return orig_train_step(self, cut, pose_batch)

        monkeypatch.setattr(Trainer, "train_step", train_step)
    elif fault == "altered":
        orig_make_batch = Trainer.make_batch

        def make_batch(self, item, mode):
            out = orig_make_batch(self, item, mode)
            out.rgb = out.rgb + 0.05
            return out

        monkeypatch.setattr(Trainer, "make_batch", make_batch)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(bench, cell, tiny_cells):
    """Set-up, window, the steps past it and the check at a tiny size: no
    device number comes out, the program equals its frozen reference on the
    CPU, its pretraining too, and it is correct."""
    res = measure(bench, cell)
    assert res["device"]["platform"] == "cpu" and res["device"]["memory_peak_bytes"] is None
    assert res["metrics"] and all(m["value"] == "not measured" for m in res["metrics"].values())
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert checks["init_gap"] == 0.0 and checks["smpl_init_gap"] == 0.0
    assert checks["loss_gap"] < 1e-6 and checks["change_gap"] < 1e-5 and checks["grad_gap"] < 1e-5
    assert checks["batch_gap"] < 1e-5
    assert checks["steps_off_mode"] == 0 and checks["updates_skipped"] == 0
    assert ("mesh_gap" in checks) == cell.endswith(".pose")
    assert set(res["diagnostics"]) == {"start", "after"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is True
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault,number", [("unchanged", "change_gap"), ("half_batch", "loss_gap"),
                                          ("altered", "batch_gap")])
def test_a_broken_step_is_not_correct(bench, fault, number, tiny_cells, monkeypatch):
    """The timed path broken underneath the harness: each run comes out not
    correct, on its own number."""
    plant(monkeypatch, fault)
    res = measure(bench, "taichi01.joint")
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_control_reads_far_above_the_program(bench):
    """The TF32 control (emulated on the CPU) parts from the f32 reference by
    far more than the program does, on the loss and on the gradients, in the
    set-up's triple and in the one past the window."""
    cell, _, config, traffic = run.cell_parts(bench, "taichi01.joint")
    records = harness.run_cell(cell, tiny(config), traffic, SEED, 0.0, False, "cpu", time.perf_counter())
    try:
        out = control.reference_readings(records, "cpu", faults=True)
    finally:
        shutil.rmtree(records["workdir"], ignore_errors=True)
    for p in ("start", "after"):
        for k in ("loss_gap", "grad_gap", "change_gap"):
            assert out["control"]["parts"][p][k] > max(10 * out["sound_parts"][p][k], 1e-5), (p, k)
    assert out["half_batch"]["loss_gap"] > 1e-2
    assert out["free"]["loss_gap"] < 1e-6 and out["free"]["change_gap"] < 1e-5  # one device: no rounding apart
    assert out["altered"]["batch_gap"] > 0.04
    assert out["smpl_init_unchanged"]["smpl_init_gap"] > 1e-2 and out["sound"]["smpl_init_gap"] == 0.0


def canned_trace(tmp_path) -> str:
    """Two traced steps: markers at each step's entry and exit, kernels between."""
    ev = []

    def k(name, ts, dur, cat="kernel"):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur})

    k("spin_kernel", 0, 1)
    k("ampere_sgemm_128x64_nn", 10, 40)
    k("nn1_kernel", 60, 20)
    k("vectorized_elementwise_kernel", 70, 20)  # overlaps the nn1 kernel
    k("spin_kernel", 100, 1)  # leaves step 1
    k("spin_kernel", 150, 1)  # enters step 2
    k("grid_trilinear_kernel", 160, 10)
    k("Memcpy HtoD (Pageable -> Device)", 180, 10, cat="gpu_memcpy")
    k("spin_kernel", 199, 1)
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 100})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_trace_reduction_and_readers_on_a_canned_trace(tmp_path):
    t = traces.reduce_trace(traces.load_events(canned_trace(tmp_path)))
    assert t["launches"] == 5
    assert t["window_s"] == pytest.approx(200e-6)
    assert t["busy_s"] == pytest.approx((40 + 30 + 10 + 10) * 1e-6)
    inside, between = t["gaps_s"]["inside train_step (host enqueue)"], t["gaps_s"]["between train_step calls (loop, producer)"]
    assert between == pytest.approx(51e-6)  # 100..150 and 199..200, from the markers that leave a step
    assert inside + between + t["busy_s"] == pytest.approx(t["window_s"])
    peak = kernels.peaks("NVIDIA H100 80GB HBM3")
    runrec = {"trace": t, "traced_steps": 2, "peak": peak, "flops": {"total": 1e6},
              "kernel_calls": [("nn1", 2, 1000, 386), ("grid_trilinear", 2, 970, 8, 97)],
              "steps": 2, "rays": 1024, "window_s": 0.5, "step_ms": [100.0, 120.0, 110.0],
              "loop_gap_ms": [1.0, 3.0], "step_host_ms": [5.0, 7.0], "producer_ms": 12.5,
              "pose_losses_ms": [2.0, 4.0], "setup_s": 30.0, "peak_bytes": 2**31}
    readers = [f[:-3] for f in os.listdir(os.path.join(ROOT, "benchmark", "metrics"))
               if f.endswith(".py") and f != "__init__.py"]
    read = {m: __import__(f"benchmark.metrics.{m}", fromlist=["read"]).read(runrec) for m in readers}
    assert read["rays_per_s"] == pytest.approx(2048.0)
    assert read["launches_per_step"] == 2.5
    assert read["gemm_ms"] == pytest.approx(0.020)
    assert read["device_idle"] == pytest.approx(100 * (1 - 90 / 200))
    assert read["mfu"] == pytest.approx(100 * 2e6 / 200e-6 / 67e12)
    assert read["nn1_roofline"] == pytest.approx(100 * kernels.nn1_bound(2, 1000, 386, peak)[0] / 20e-6)
    assert read["grid_trilinear_roofline"] == pytest.approx(100 * kernels.grid_bound(2, 970, 8, 97, peak)[0] / 10e-6)
    assert read["step_ms_p95"] == pytest.approx(119.0)
    assert read["loop_gap_ms"] == 2.0 and read["step_host_ms"] == 6.0 and read["producer_ms"] == 12.5
    assert read["pose_losses_ms"] == 3.0 and read["setup_s"] == 30.0 and read["peak_mem_gib"] == 2.0
    # a reader with nothing to read returns nothing, never 0
    empty = {"trace": None, "kernel_calls": [], "steps": 0, "window_s": None, "step_ms": None}
    for m in ("mfu", "nn1_roofline", "grid_trilinear_roofline", "device_idle", "gemm_ms", "rays_per_s"):
        assert __import__(f"benchmark.metrics.{m}", fromlist=["read"]).read(empty) is None


def test_kernel_bounds_match_the_tabulated_ones():
    """PERF.md's kernel table: nn1 at P=2, N=65,536, V=6,890 is bound by its
    operations at 0.1213 ms; the res-64 grid at group=97 by its bytes at 0.000983 ms."""
    peak = kernels.peaks("NVIDIA H100 80GB HBM3")
    t, by = kernels.nn1_bound(2, 65_536, 6_890, peak)
    assert by == "operations" and round(t * 1e3, 4) == 0.1213
    t, by = kernels.grid_bound(2, 49_664, 64, 97, peak)
    assert by == "bytes" and round(t * 1e3, 6) == 0.000983
    t, by = kernels.grid_bound(2, 49_664, 64, 1, peak)
    assert by == "bytes" and round(t * 1e3, 5) == 0.00110


def test_step_flops_of_the_configurations(bench):
    """taichi01: 1.63 TFLOP a step, term by term; mmm3 scales the per-person terms by 3/2."""
    cfg = harness.load_yaml(os.path.join(ROOT, "benchmark/configs/taichi01.yaml"))
    f2 = kernels.step_flops(cfg["model"], 2, 512, 6890)
    assert kernels.implicit_macs(cfg["model"]["implicit_network"], 69) == 542_208
    assert kernels.implicit_macs(cfg["model"]["bg_implicit_network"], 32) == 532_736
    assert kernels.rendering_macs(cfg["model"]["rendering_network"], 32) == 266_496
    assert f2["total"] == pytest.approx(1.63e12, rel=0.01)
    f3 = kernels.step_flops(cfg["model"], 3, 512, 6890)
    person_terms = ("sampler", "render_implicit", "render_color", "eikonal")
    assert all(f3[k] == pytest.approx(1.5 * f2[k]) for k in person_terms)
    assert f3["background"] == f2["background"]


def test_the_forbidden_module_check_compares_whole_top_level_names():
    mods = ["multiply_tpu_torch", "multiply_tpu_torch.engine.trainer", "jaxtyping", "numpy", "flaxen.x"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["jax", "jaxlib.xla_client", "multiply_tpu.config", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "multiply_tpu.config"]


def test_no_card_no_result(capsys, monkeypatch):
    """Without a card the command exits non-zero and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "taichi01.joint", "--seed", "1", "--seconds", "1", "--trace", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_benchmark_json_names_files_of_its_own(bench):
    """Every configuration, traffic mix, metric and limit is a file found by
    its name; names and units keep to the contract's characters."""
    assert bench["command"] == ["python3", "benchmark/run.py"] and bench["paths"] == ["benchmark"]
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.yaml"))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "limits", f"{w['name']}.json"))
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert "setup_s" in names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    assert all(m["moves"] == "rays_per_s" for m in bench["per_layer"])


@pytest.mark.cuda
def test_control_on_the_card(bench):
    """On the card the control is the hardware's TF32; at a tiny size it
    still parts from the f32 reference by more than the program does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell, _, config, traffic = run.cell_parts(bench, "taichi01.joint")
    records = harness.run_cell(cell, tiny(config), traffic, SEED, 0.0, False, "cuda", time.perf_counter())
    try:
        out = control.reference_readings(records, "cuda", faults=False)
    finally:
        shutil.rmtree(records["workdir"], ignore_errors=True)
    assert out["control"]["loss_gap"] > out["sound"]["loss_gap"]
