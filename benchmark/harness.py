"""One run of one cell: set-up, the measured window, the trace, the check.

The window drives the trainer that the port's training entry builds
(`multiply_tpu_torch/cli/train.py::build_trainer`) through
`Trainer.train_epoch`, epoch after epoch, as a user's run does. The harness
wraps methods of the trainer's instances, from here, to time the layers and
to end the window:
  * `trainer.train_step`: the step boundaries (host clock and a CUDA event
    each), the window's end at the first boundary after `--seconds`, the
    trace's start and stop, and the captures the check reads: set-up's first
    three steps, and three steps of one more epoch past the window;
  * `seq.get_train_item`, `trainer.make_batch`, `trainer.pose_loss_batch`:
    the producer thread's time a batch; they stop the producer once a phase
    has ended, so an epoch cut short drains at once;
  * `trainer.builder._pose_step_losses`: CUDA events around the mesh losses;
  * `knn_cuda.nn1_kernel`, `grid_cuda.grid_trilinear_kernel`: the shapes of
    the traced calls, for the kernels' rooflines.
"""

from __future__ import annotations

import copy
import gc
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from argparse import Namespace

import numpy as np
import torch
import yaml

from . import check as check_mod
from . import scene as scene_mod
from .reference.config import Config

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")
META_KEYS = ("source", "reduced", "assumed", "scene")
MODES = {"joint": 0, "pose_only": 1, "delayed_pose": 2}


class PhaseEnded(Exception):
    """Raised at a step boundary once set-up or the window is over."""


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def set_dotted(conf: dict, key: str, value) -> None:
    *path, last = key.split(".")
    node = conf
    for p in path:
        node = node.setdefault(p, {})
    node[last] = value


def to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu().clone()
    return x


class Recorder:
    """Wraps the trainer's instances and keeps what each phase records.

    Phases: "setup" (the warm steps; the check's first part follows its first
    three), "window" (measured) and "after" (three steps past the window,
    through the same call and feed; the check's second part follows them)."""

    def __init__(self, trainer, device, traffic: dict, workdir: str):
        self.trainer, self.device, self.workdir = trainer, torch.device(device), workdir
        self.cuda = self.device.type == "cuda"
        self.lock = threading.Lock()
        self.phase, self.ended = "setup", False
        self.warm_steps = int(traffic["warm_steps"])
        self.deadline = None
        self.seconds = None
        self.calls = 0  # train_step calls over the run
        self.part_calls = 0  # train_step calls of the setup or after phase
        self.parts: dict = {"start": {"caps": []}, "after": {"caps": []}}
        self.modes: list[int] = []
        self.skipped = 0
        # window records
        self.steps: list[dict] = []  # {t0, t1, rays, event}
        self.producer: list[float] = []  # seconds of each wrapped producer call in the window
        self.batches = 0
        self.pose_events: list[tuple] = []
        self.t_start = self.t_end = None
        self.end_event = None
        # trace
        self.trace_on = False
        self.trace_plan: tuple[int, int] | None = None  # (first window step traced, steps)
        self.profiler = None
        self.traced_steps = 0
        self.kernel_calls: list[tuple] = []
        self.trace_path = None
        self._install()

    # -- wrappers ----------------------------------------------------------

    def _install(self) -> None:
        tr = self.trainer
        orig_step, orig_item = tr.train_step, tr.seq.get_train_item
        orig_batch, orig_pose = tr.make_batch, tr.pose_loss_batch
        orig_losses = tr.builder._pose_step_losses
        rec = self

        def timed_producer(fn):
            def wrapper(*args, **kwargs):
                if rec.ended:
                    raise PhaseEnded()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if rec.phase == "window":
                    with rec.lock:
                        rec.producer.append(time.perf_counter() - t0)
                return out
            return wrapper

        def make_batch(item, mode):
            out = timed_producer(orig_batch)(item, mode)
            if rec.phase == "window":
                with rec.lock:
                    rec.batches += 1
            return out

        def pose_step_losses(*args, **kwargs):
            if rec.phase != "window" or not rec.cuda:
                return orig_losses(*args, **kwargs)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig_losses(*args, **kwargs)
            b.record()
            rec.pose_events.append((a, b))
            return out

        def train_step(batch, pose_batch=None):
            return rec.step(orig_step, batch, pose_batch)

        tr.train_step = train_step
        tr.seq.get_train_item = timed_producer(orig_item)
        tr.make_batch = make_batch
        tr.pose_loss_batch = timed_producer(orig_pose)
        tr.builder._pose_step_losses = pose_step_losses
        self._wrap_kernels()

    def _wrap_kernels(self) -> None:
        from multiply_tpu_torch.ops import grid_cuda, knn_cuda

        self._kernel_origs = (knn_cuda.nn1_kernel, grid_cuda.grid_trilinear_kernel)
        nn1_orig, grid_orig = self._kernel_origs
        rec = self

        def nn1_kernel(query, refs, exact=False):
            if rec.trace_on:
                P = query.shape[0] if query.dim() == 3 else 1
                rec.kernel_calls.append(("nn1", P, query.shape[-2], refs.shape[-2]))
            return nn1_orig(query, refs, exact)

        def grid_trilinear_kernel(grid, points, origin, spacing, group=1):
            if rec.trace_on:
                P = grid.shape[0] if grid.dim() == 4 else 1
                rec.kernel_calls.append(("grid_trilinear", P, points.shape[-2], grid.shape[-1], group))
            return grid_orig(grid, points, origin, spacing, group)

        knn_cuda.nn1_kernel, grid_cuda.grid_trilinear_kernel = nn1_kernel, grid_trilinear_kernel

    def uninstall(self) -> None:
        from multiply_tpu_torch.ops import grid_cuda, knn_cuda

        knn_cuda.nn1_kernel, grid_cuda.grid_trilinear_kernel = self._kernel_origs
        self.trainer = None

    # -- the step boundary -------------------------------------------------

    def _marker(self) -> None:
        if self.trace_on:
            torch.cuda._sleep(1)

    def step(self, orig_step, batch, pose_batch):
        now = time.perf_counter()
        part = None
        if self.phase == "window":
            if self.deadline is None:
                self.t_start, self.deadline = now, now + self.seconds
            elif now >= self.deadline:
                self.close_window()
                raise PhaseEnded()
            if self._trace_boundary() and self.steps:
                self.steps[-1]["profiler_in_interval"] = True  # its interval holds the profiler's start or stop
        else:
            part = self.parts["start" if self.phase == "setup" else "after"]
            k = self.part_calls + 1
            if k <= 4:
                self._capture_before(part, k, batch, pose_batch)
            if k > (self.warm_steps if self.phase == "setup" else 3):
                self.ended = True
                raise PhaseEnded()
            self.part_calls = k
        self.calls += 1
        event = None
        if self.phase == "window" and self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self._marker()
        t0 = time.perf_counter()
        ts, logs = orig_step(batch, pose_batch)
        t1 = time.perf_counter()
        self._marker()
        self.modes.append(int(batch.mode))
        self.skipped += int(logs.get("update_skipped", 0.0) != 0.0)
        if part is not None and self.part_calls <= 3:
            self._capture_after(part, self.part_calls, logs)
        if self.phase == "window":
            self.steps.append({"entry": now, "t0": t0, "t1": t1, "rays": int(batch.uv.shape[0]), "event": event})
            if self.trace_on:
                self.traced_steps += 1
        return ts, logs

    def _opt_state(self, which: str) -> dict:
        opt = getattr(self.trainer.ts, which)
        return {"mu": {n: to_cpu(m) for n, m in opt.mu.items()}, "nu": {n: to_cpu(v) for n, v in opt.nu.items()},
                "count": dict(opt.count)}

    def _capture_before(self, part: dict, k: int, batch, pose_batch) -> None:
        """Before the part's step k: the parameters (k <= 4), the optimizers'
        and the noise generator's state and the batch (k <= 3). The check's
        reference takes each of the three steps from the state before it."""
        tr = self.trainer
        part[f"params{k - 1}"] = {n: to_cpu(p) for n, p in tr.ts.params().items()}
        if k == 4:
            return
        part[f"opt{k - 1}"] = {w: self._opt_state(w) for w in ("opt_joint", "opt_pose")}
        part[f"gen{k - 1}"] = tr.gen.get_state()
        b = {f: to_cpu(getattr(batch, f)) for f in ("uv", "rgb", "pose", "intrinsics", "frame_idx", "smpl_scale",
                                                    "sam_mask", "mode")}
        pb = None
        if pose_batch is not None:
            pb = {f: to_cpu(getattr(pose_batch, f)) for f in ("verts_c", "faces", "uv", "sam_probs", "scale_to_full")}
        part["caps"].append({"batch": b, "pose_batch": pb, "epoch": int(tr.epoch)})

    def _capture_after(self, part: dict, k: int, logs: dict) -> None:
        part["caps"][k - 1]["logs"] = {n: float(v) for n, v in logs.items()}

    # -- window and trace --------------------------------------------------

    def start_window(self, seconds: float, trace_plan=None) -> None:
        self.phase, self.ended, self.seconds, self.trace_plan = "window", False, float(seconds), trace_plan

    def start_after(self) -> None:
        self.phase, self.ended, self.part_calls = "after", False, 0

    def close_window(self) -> None:
        if self.cuda:
            self.end_event = torch.cuda.Event(enable_timing=True)
            self.end_event.record()
            torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        self._stop_trace()
        self.ended = True

    def _trace_boundary(self) -> bool:
        """Start or stop the profiler at this boundary; whether it did."""
        if self.trace_plan is None or not self.cuda:
            return False
        first, n = self.trace_plan
        i = len(self.steps)
        if i == first and self.profiler is None:
            torch.cuda.synchronize()
            self.profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.profiler.__enter__()
            self.trace_on = True
            return True
        if i == first + n and self.trace_on:
            self._stop_trace()
            return True
        return False

    def _stop_trace(self) -> None:
        if self.profiler is None or not self.trace_on:
            return
        torch.cuda.synchronize()
        self.trace_on = False
        self.profiler.__exit__(None, None, None)
        self.trace_path = os.path.join(self.workdir, "trace.json")
        self.profiler.export_chrome_trace(self.trace_path)
        self.profiler = None


def cache_key(*parts) -> str:
    return hashlib.sha256(json.dumps(parts, sort_keys=True, default=str).encode()).hexdigest()[:16]


def run_conf(config: dict, traffic: dict, seed: int, body_dir: str, betas: np.ndarray) -> dict:
    """The configuration as the program runs it: the file's, the traffic's
    settings, the seed, and the run's paths. `smpl_init` pretrains on the
    first person's canonical body (`betas`), so its cache is keyed by it."""
    conf = {k: copy.deepcopy(v) for k, v in config.items() if k not in META_KEYS}
    for key, value in (traffic.get("set") or {}).items():
        set_dotted(conf, key, value)
    conf["seed"] = int(seed)
    conf["smpl_model_path"] = body_dir
    conf["sam_checkpoint"] = None
    model = conf["model"]
    model["sam_checkpoint"] = None
    net = {k: v for k, v in model["implicit_network"].items() if k != "number_person"}  # one network a gender
    init_key = cache_key(body_dir.rsplit(os.sep, 1)[-1], np.asarray(betas).tolist(), net,
                         model.get("smpl_init_steps", 2000))
    model["smpl_init_cache_dir"] = os.path.join(CACHE_DIR, "smpl_init", init_key)
    return conf


def run_cell(workload: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
             t_begin: float) -> dict:
    """Set up, measure for `seconds`, optionally trace, take three steps past
    the window for the check; returns the run's records (the result line is
    made from them by `run.py`). `setup_s` leaves out writing the training
    directory, the benchmark's own input."""
    from multiply_tpu_torch.cli.train import build_trainer

    workdir = tempfile.mkdtemp(prefix="bench-")
    phases, mark = {}, [time.perf_counter()]

    def phase(name: str) -> None:
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    phases["imports"] = mark[0] - t_begin
    try:
        num_person = int(config["dataset"]["train"]["num_person"])
        body_dir = scene_mod.smpl_dir(config["scene"], CACHE_DIR)
        scene = scene_mod.make_scene(config["scene"], num_person, seed, body_dir, device)
        phase("scene")
        data_dir, run_dir = os.path.join(workdir, "data"), os.path.join(workdir, "run")
        scene_mod.write_sequence(scene, data_dir)
        phase("write")
        conf = run_conf(config, traffic, seed, body_dir, scene["betas"][0])
        conf_path = os.path.join(workdir, "conf.yaml")
        with open(conf_path, "w") as f:
            yaml.safe_dump(conf, f)
        args = Namespace(conf=conf_path, data_root=data_dir, run_dir=run_dir, sets=[], device=str(device),
                         is_continue=False, max_epochs=None, profile=0, devices=0)
        trainer, _, _ = build_trainer(args)
        phase("trainer")
        # the epoch-0 instance-mask and SAM stages, so that the SAM files exist
        trainer.instance_mask_stage(epoch=0)
        trainer.sam_stage(epoch=0)
        phase("masks")

        rec = Recorder(trainer, device, traffic, workdir)
        epoch = int(traffic["first_epoch"])
        stride = int(traffic["epoch_stride"])
        trainer.epoch = epoch
        try:
            trainer.train_epoch()
        except PhaseEnded:
            pass
        if rec.part_calls < rec.warm_steps:
            raise RuntimeError(f"set-up made {rec.part_calls} steps, {rec.warm_steps} wanted")
        if rec.cuda:
            torch.cuda.synchronize()
        phase("warm_steps")
        setup_s = time.perf_counter() - t_begin - phases["scene"] - phases["write"]

        plan = (int(traffic["trace_skip"]), int(traffic["trace_steps"])) if trace else None
        rec.start_window(seconds, plan)
        while not rec.ended:
            epoch += stride
            trainer.epoch = epoch
            try:
                trainer.train_epoch()
            except PhaseEnded:
                break
        if not rec.ended:
            rec.close_window()
        peak = torch.cuda.max_memory_allocated() if rec.cuda else None

        rec.start_after()
        trainer.epoch = epoch + stride
        try:
            trainer.train_epoch()
        except PhaseEnded:
            pass
        if "params3" not in rec.parts["after"]:
            raise RuntimeError(f"the epoch past the window made {rec.part_calls} steps, 3 wanted")
        stage = trainer.seq.sam_pickup.path
        sam_logits = np.load(stage).transpose(0, 2, 3, 1) if stage else None  # (F, H, W, P)
        rec.uninstall()
        del trainer
        gc.collect()
        if rec.cuda:
            torch.cuda.empty_cache()

        records = window_records(rec)
        records.update(setup_s=setup_s, setup_phases=phases, peak_bytes=peak, trace_path=rec.trace_path, traced_steps=rec.traced_steps,
                       kernel_calls=rec.kernel_calls, modes=rec.modes, skipped=rec.skipped,
                       expected_mode=MODES[traffic["mode"]], workdir=workdir)
        records["conf"] = conf
        records["prog"] = rec.parts
        records["scene"] = scene
        records["body_dir"] = body_dir
        records["sam_logits"] = sam_logits
        return records
    except BaseException:
        shutil.rmtree(workdir, ignore_errors=True)
        raise


def window_records(rec: Recorder) -> dict:
    steps = rec.steps
    out = {"steps": len(steps), "rays": sum(s["rays"] for s in steps)}
    out["window_s"] = (rec.t_end - rec.t_start) if steps else None
    if rec.cuda and steps:
        events = [s["event"] for s in steps] + [rec.end_event]
        out["step_ms"] = [a.elapsed_time(b) for a, b, s in zip(events[:-1], events[1:], steps)
                          if not s.get("profiler_in_interval")]
        out["pose_losses_ms"] = [a.elapsed_time(b) for a, b in rec.pose_events]
    else:
        out["step_ms"] = None
        out["pose_losses_ms"] = None
    out["step_host_ms"] = [1e3 * (s["t1"] - s["t0"]) for s in steps]
    out["loop_gap_ms"] = [1e3 * (b["entry"] - a["t1"]) for a, b in zip(steps[:-1], steps[1:])]
    out["producer_ms"] = 1e3 * sum(rec.producer) / rec.batches if rec.batches else None
    return out


def run_check(records: dict, limits: dict, device):
    """(correct, {number: {"value", "limit"}}, what each part of the check read).
    Every number that the cell's limits name is compared."""
    nums, parts = check_mod.check(Config(records["conf"]), records["scene"], records["body_dir"], records["prog"],
                                  records["sam_logits"], device)
    checks = {name: {"value": nums.get(name, float("nan")), "limit": limit} for name, limit in limits.items()}
    ok = bool(limits) and all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    off_mode = sum(m != records["expected_mode"] for m in records["modes"])
    checks["steps_off_mode"] = {"value": off_mode, "limit": 0}
    checks["updates_skipped"] = {"value": records["skipped"], "limit": 0}
    return ok and off_mode == 0 and records["skipped"] == 0, checks, parts
