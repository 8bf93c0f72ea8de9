#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: needs CUDA (there is no CPU path); prints the card's name and
     power limit and turns TF32 off for matmuls and cuDNN;
  2. build: compiles both hand-written kernels from `multiply_tpu_torch/csrc`
     (one nvcc per source, in parallel) into `multiply_tpu_torch/_build`, plus
     the exactly rounded build of `nn1` that only the checks use; prints
     ptxas's registers and spills, and for `nn1` the instruction mix of its
     inner loop from `cuobjdump -sass`;
  3. set-up: the synthetic 2-person scene and the per-person state with the
     canonical SDF grids baked at res 64, at the widths of
     `confs/model/taichi01_model.yaml`, weights random from a seed;
  4. kernels: each kernel against its plain PyTorch version on the card at
     the training step's shapes (`grid_trilinear` per point and fused with the
     per-ray minimum; `nn1` at V = 386 and 6890, at N = 512 and on the padded
     meshes that a pose-only step warps, and its exactly rounded build bit for
     bit), with times of kernel, plain version and a
     PyTorch library yardstick (never called by the port), the wrapper's host
     time, the kernels launched per wrapper call and the card's least time for
     the same work (`bound_ms`);
  5. training, parity preset (`taichi01_model.yaml`): full-width training
     steps of 512 rays over different frames with launch counters zeroed just
     before; asserts finite losses, no skipped update, changed params and the
     kernels' launch counts; one profiled step; then one full frame rendered
     in 512-ray chunks and its PSNR;
  6. path F, the fast preset (`taichi01_base.yaml` with
     `model/taichi01_fast_model.yaml`: bfloat16 sampler, box-clipped ray
     ranges): timed full-width steps and a profiled one, printed beside the
     parity preset's figures, with the GEMM kernels' device time by name;
  7. path P, pose-only steps with a `PoseLossBatch` of the synthetic scene
     (body meshes padded to 8192 faces, 2048 pixels, 5120 interpenetration
     samples, the two bodies overlapping): asserts the three pose losses are
     there and not all zero, every `body.*` leaf moved and no `net.*` leaf;
  8. one full-width step each of the sorted composite, the shared shape net
     with offset heads and beta encoders, `cond: smpl_tri`, and the
     multi-resolution tri-plane: finite loss, finite non-zero gradients on
     each new parameter group;
  9. path T, the trainer (`run_path_t`): the training entry's code
     (`multiply_tpu_torch.cli.train`) on `confs/synthetic_fullscale.yaml` at
     full width, 2 frames of 270x360, run A for 21 epochs across epoch 0's
     instance-mask + SAM stages, validation render and checkpoint, and epoch
     20's mesh refresh and opt_depth with its depth-map dumps; run B resumes a
     fresh trainer from `last`, checks that the parameters, both Adam states
     and the epoch came back, and trains one pose-only epoch; then the
     learned-mesh instance-mask stage, 50 SMPL-init steps and one frame of the
     test entry. Holds each kernel to its plain version on the first call of
     each new shape that the path hands it (the steps, the warps of learned
     and padded meshes, the validation render's chunks), on the path's own
     output. Asserts every artifact, every step's finite loss, the mode
     of every step against `_select_mode` and that the mesh refresh changed
     the grid the step reads; prints seconds per epoch and per stage, steps
     per mode, the kernels' launches, peak memory and the validation PSNR;
 10. path S, the SAM refinement path (`run_path_s`): `vit_h` with seeded
     random weights (non-zero `pos_embed` and rel-pos tables) saved in the
     official `segment_anything` layout; one 270x360 frame encoded in f32, in
     float64 and with TF32 allowed, the f32 error held to SAM_F64_TOL and
     TF32's required to exceed it; encode and `predict` timed; then the
     training entry's code on path T's configuration with `--set
     sam_checkpoint=<file>` for epochs 0-1: the stage must be `SamSegmenter`
     and write finite (2, 2, 270, 360) logits that the sequence picks up and
     epoch 1 trains on; prints the encoder's parameters, FLOP count and bound,
     the encode and predict times, the stage's seconds and the peak memory of
     the encode and of the stage. The checkpoint file is deleted after;
 11. `cli/train.py --profile 3` on path T's configuration and its table of
     device time by category.
Each of the paths 5-7, 9 and 10 zeroes the kernels' launch counters just
before it and reads them just after. Prints the `{"kernels": [...]}` line,
then the nvidia-smi line, then `{"ok": true, "device": {...}}` as the last
line.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 11  # parity preset: step 0 warms up; the rest are timed
STEPS_FAST = 7  # fast preset: one first step, six timed
STEPS_POSE = 4  # pose-only: one first step, three timed
RAYS = 512
POSE_PIXELS = 2048  # pixels of a pose-loss batch
MESH_BUCKET = 8192  # vertex and face counts of a pose-loss batch's padded meshes
INTERP_SAMPLES = 5120  # interpenetration samples per person
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
NN1_OPS_PER_PAIR = 9  # 3 sub, 3 mul, 2 add, 1 compare
GRID_OPS_PER_POINT = 40  # 3x (sub, div, 2 clamps, floor, sub, min) + 7 lerps x 3
LAUNCHES_BEFORE = 7447  # kernel launches of one step before the kernels' wrappers were thinned
# path T: the training entry on the full-scale synthetic config, cut to 2 frames
TRAIN_CONF = os.path.join("confs", "synthetic_fullscale.yaml")
RUN_A_SETS = ("dataset.train.end_frame=2", "model.num_training_frames=2", "model.depth_epoch=[20]",
              "model.it_per_loop=5")
RUN_B_SETS = ("model.depth_end=false", "model.pose_start_epoch=1", "model.pose_opt_interval=1")
EPOCHS_A = 21
SMPL_INIT_STEPS = 50
LEARNED_MESH_EPOCH = 191  # the instance-mask stage warps learned meshes after epoch 190
# path S: the SAM refinement path at vit_h width, random weights in the official layout
SAM_VARIANT = "vit_h"
SAM_EPOCHS = 2  # epoch 0 (instance masks + SAM stage), then epoch 1 trains on the refined masks
# max |f32 - f64| of the encoder's output (unit scale after its last LayerNorm): on the H100 f32 gave
# 1.23e-5 and TF32 5.17e-3 (NVIDIA H100 80GB HBM3 at 700 W, PERF.md §5); the bound sits 20x above the one and
# 20x below the other
SAM_F64_TOL = 2.5e-4
PROFILE_STEPS = 3


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, reps=30, warmup=5):
    """Median of per-call CUDA-event times after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_nn1(q, r, name):
    """Kernel vs plain on one input; returns (max_abs_err, n_idx_mismatch). Also
    holds the exactly rounded build to the plain version bit for bit."""
    import torch

    from multiply_tpu_torch.ops import knn_cuda

    d2_e, idx_e = knn_cuda.nn1_kernel(q, r, exact=True)
    d2_p, idx_p = knn_cuda.nn1_plain(q, r)
    assert torch.equal(d2_e, d2_p) and torch.equal(idx_e, idx_p), f"{name}: exact build differs"
    return compare_nn1(q, r, *knn_cuda.nn1_kernel(q, r), name)


def compare_nn1(q, r, d2_k, idx_k, name):
    """The kernel's output (d2_k, idx_k) on (q, r) against the plain version:
    d2 within 1e-6 relative, an index apart only at a tie within 1e-6.
    Returns (max_abs_err, n_idx_mismatch)."""
    import torch

    from multiply_tpu_torch.ops import knn_cuda

    d2_p, idx_p = knn_cuda.nn1_plain(q, r)
    assert d2_k.shape == d2_p.shape and idx_k.shape == idx_p.shape, f"{name}: shapes"
    assert idx_k.dtype == torch.int64 and bool((d2_k >= 0).all()), f"{name}: output form"
    rel = ((d2_k - d2_p).abs() / d2_p.clamp_min(1e-30)).max().item()
    assert rel <= 1e-6, f"{name}: d2 relative error {rel} > 1e-6"
    # a differing index is allowed only where the two candidates tie within 1e-6
    diff = (idx_k != idx_p)[..., 0]
    n_diff = int(diff.sum())
    if n_diff:
        chosen = torch.take_along_dim(r, idx_k.expand(idx_k.shape[:-1] + (3,)), dim=-2)
        d_chosen = ((q - chosen) ** 2).sum(-1)
        gap = ((d_chosen - d2_p[..., 0]).abs() / d2_p[..., 0].clamp_min(1e-30))[diff]
        assert gap.max().item() <= 1e-6, f"{name}: index differs away from a tie ({gap.max().item()})"
    return (d2_k - d2_p).abs().max().item(), n_diff


def host_time_us(fn, calls=1000, batch=250):
    """Host time of one call of `fn`, in microseconds: (mean, fastest batch's
    mean) of the host clock around `calls` calls with no synchronise inside
    (one between batches, outside the clock, so that the launch queue never
    fills and the host never waits for the card)."""
    import torch

    fn()
    times = []
    for _ in range(calls // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) / batch * 1e6)
    torch.cuda.synchronize()
    return sum(times) / len(times), min(times)


def device_time_ms(fn, kernel_substr, reps=20):
    """From a torch.profiler trace of `reps` calls of `fn`: (mean device time of
    the kernels whose name holds `kernel_substr`, or None if the trace has none;
    device kernels launched per call, of any name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels if kernel_substr in e.key)
    return (total / reps / 1e3 if total > 0 else None), sum(e.count for e in kernels) / reps


SASS_COUNTED = ("LDS", "FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "SEL")


def sass_inner_loop(lib_path, kernel_substr):
    """Instruction mix of the innermost loop with the most FFMA in the kernel
    whose name holds `kernel_substr`, from `cuobjdump -sass`: a dict of counts
    with "total", or a string saying why there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    exe = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.isfile(exe):
        return "cuobjdump not found"
    text = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    body = next((f for f in text.split("Function :")[1:] if kernel_substr in f.splitlines()[0]), None)
    if body is None:
        return f"no function named *{kernel_substr}* in the SASS"
    instrs = []  # (address, opcode, branch target or None)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);", body):
        target = re.search(r"0x([0-9a-f]+)", m.group(3)) if m.group(2).startswith("BRA") else None
        instrs.append((int(m.group(1), 16), m.group(2).split(".")[0], int(target.group(1), 16) if target else None))
    loops = [(t, a) for a, op, t in instrs if op == "BRA" and t is not None and t <= a]
    inner = [l for l in loops if not any(o != l and l[0] <= o[1] < l[1] for o in loops)]
    best = None
    for lo, hi in inner:
        ops = [op for a, op, _ in instrs if lo <= a <= hi]
        counts = {k: ops.count(k) for k in SASS_COUNTED} | {"total": len(ops)}
        if best is None or counts["FFMA"] + counts["FMUL"] > best["FFMA"] + best["FMUL"]:
            best = counts
    return best or "no loop found in the SASS"


def step_breakdown(step_fn, top=10, with_cpu=True):
    """Profile one call of `step_fn`: (wall ms, device-busy ms, top kernels by
    device time, kinds of kernel, kernel launches, GEMM kernels). Without
    `with_cpu` only the card's activity is traced, a much lighter event load."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multiply_tpu_torch.utils.profiling import HAND_WRITTEN, is_gemm

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if with_cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    ours = [e for e in kernels if any(k in e.key for k in HAND_WRITTEN)]
    rows = [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in kernels[:top] + ours]
    gemms = [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in kernels if is_gemm(e.key)]
    return wall, busy, rows, len(kernels), sum(e.count for e in kernels), gemms


def gemm_summary(gemms):
    """(bf16 ms, other ms) of the GEMM kernels of one profiled step, by name."""
    bf16 = sum(ms for name, ms, _ in gemms if "bf16" in name.lower())
    return bf16, sum(ms for _, ms, _ in gemms) - bf16


def make_batch(scene, f, rng, dev, rays=RAYS, mode=0):
    import torch

    from multiply_tpu_torch.data.synthetic import sample_rays
    from multiply_tpu_torch.engine.train import Batch

    r = sample_rays(scene, f, rays, rng)
    return Batch(
        uv=torch.as_tensor(r["uv"], device=dev), rgb=torch.as_tensor(r["rgb"], device=dev),
        pose=torch.as_tensor(scene.cam_pose[f], device=dev),
        intrinsics=torch.as_tensor(scene.intrinsics, device=dev), frame_idx=f,
        smpl_scale=torch.as_tensor(scene.scale, device=dev),
        sam_mask=torch.as_tensor(r["sam"], device=dev), mode=mode,
    )


def body_tables(scene, dev, transl=None):
    from multiply_tpu_torch.body.params import BodyParamTable

    transl = scene.transl if transl is None else transl
    n_frames, n_persons = scene.poses.shape[:2]
    return BodyParamTable.stack([
        BodyParamTable.create(
            n_frames, betas=scene.betas[p], global_orient=scene.poses[:, p, :3],
            transl=transl[:, p], body_pose=scene.poses[:, p, 3:], device=dev,
        )
        for p in range(n_persons)
    ])


def pose_loss_batch(scene, f, rng, dev, pixels=POSE_PIXELS, bucket=MESH_BUCKET):
    """A `PoseLossBatch` of the synthetic scene, made by the trainer's own
    functions: each person's canonical body mesh padded to `bucket` vertices and
    faces (padding repeats the last vertex; faces 0,0,0), and `pixels` pixels
    drawn where the instance masks are confident, with the SAM probabilities there."""
    from multiply_tpu_torch.engine.trainer import draw_pose_pixels, pose_batch_from_meshes

    drawn = draw_pose_pixels(scene.sam_logits[f], pixels, rng)
    assert drawn is not None, "no confident pixel in the synthetic frame"
    meshes = [(s.verts_c.cpu().numpy(), s.model.faces.cpu().numpy()) for s in scene.servers]
    return pose_batch_from_meshes(meshes, *drawn, bucket, dev)


def run_steps(name, stepper, ts, batches, gen, pose_batches=None):
    """Take one step per batch, each timed on the host clock around a
    synchronise; every log must be finite and no update skipped.
    Returns (ts, seconds per step, last logs)."""
    import torch

    step_s = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, logs = stepper.step(ts, batch, generator=gen,
                                pose_batch=None if pose_batches is None else pose_batches[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in logs.items()}
        assert all(math.isfinite(v) for v in vals.values()), f"{name} step {i}: non-finite {vals}"
        assert vals["update_skipped"] == 0.0, f"{name} step {i}: update skipped"
        extra = "".join(f" {k[5:-5]} {vals[k]:.5f}" for k in vals if k.startswith("pose_") and pose_batches)
        log(f"{name} step {i} frame {batch.frame_idx}: loss {vals['loss']:.5f} rgb {vals['rgb_loss']:.5f} "
            f"eik {vals['eikonal_loss']:.5f}{extra} {step_s[-1] * 1e3:.1f} ms")
    return ts, step_s, vals


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def model_conf_with(conf, **updates):
    """A copy of a model config; `a__b=v` sets conf["a"]["b"] = v."""
    from multiply_tpu_torch.config import Config

    data = Config(conf.to_dict()).to_dict()
    for key, value in updates.items():
        *path, last = key.split("__")
        node = data
        for k in path:
            node = node[k]
        node[last] = value
    return Config(data)


VARIANTS = (  # name, config updates, the parameter groups each adds
    ("sort composite", dict(composite_matmul=False), ()),
    ("shared net + offset head + beta encoder",
     dict(use_person_encoder=True, implicit_network__cond="smpl_id", implicit_network__offset_head=True,
          implicit_network__beta_encoding=True),
     ("net.person_latent", "net.offset_head.", "net.beta_encoder.")),
    ("cond smpl_tri", dict(implicit_network__cond="smpl_tri"), ("net.triplane.",)),
    ("multi_triplane", dict(implicit_network__cond="smpl_tri", implicit_network__multi_triplane=True),
     ("net.triplane.planes_", "net.triplane.dense.")),
)


def run_variant(name, conf, groups, scene, state, dev, seed, rays=RAYS):
    """Two full-width steps of one model configuration. The first is timed
    (the first step of its shapes: printed, not compared). The second step's
    gradients are read: conditioning that enters through layer 0 is silent at
    the geometric init (its columns start at zero), so a new group's gradient
    can be exactly zero on the first step."""
    import numpy as np
    import torch

    from multiply_tpu_torch.engine.train import TrainStep
    from multiply_tpu_torch.models.loss import LossConfig
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    gen = torch.Generator(dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n_frames, n_persons = scene.poses.shape[:2]
    renderer = MultiplyRenderer(conf, num_persons=n_persons, num_frames=n_frames, generator=gen, device=dev)
    stepper = TrainStep(renderer, state, LossConfig(sam_start_epoch=0), learning_rate=conf.learning_rate)
    ts = stepper.init_state(body_tables(scene, dev))
    torch.cuda.reset_peak_memory_stats()
    ts, step_s, _ = run_steps(name, stepper, ts, [make_batch(scene, 0, rng, dev, rays)], gen)
    loss, _, grads = stepper.loss_and_grads(ts, make_batch(scene, 1, rng, dev, rays), generator=gen)
    torch.cuda.synchronize()
    assert math.isfinite(float(loss.detach())), f"{name}: non-finite loss"
    for group in groups:
        leaves = {k: g for k, g in grads.items() if k.startswith(group)}
        assert leaves, f"{name}: no parameter named {group}*"
        assert all(bool(torch.isfinite(g).all()) for g in leaves.values()), f"{name}: non-finite gradient in {group}*"
        assert all(float(g.abs().max()) > 0 for g in leaves.values()), f"{name}: zero gradient in {group}*"
    n_params = sum(p.numel() for p in renderer.parameters())
    log(f"variant {name}: step {step_s[0] * 1e3:.1f} ms (first step of its shapes), {n_params / 1e6:.2f} M net "
        f"parameters, peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, second loss "
        f"{float(loss.detach()):.5f}, gradients finite and non-zero on {list(groups) or 'no new group'}")


def zero_counts():
    from multiply_tpu_torch.ops import grid_cuda, knn_cuda

    knn_cuda.nn1.launches = 0
    grid_cuda.grid_trilinear.launches = 0


def read_counts():
    from multiply_tpu_torch.ops import grid_cuda, knn_cuda

    return {"nn1": knn_cuda.nn1.launches, "grid_trilinear": grid_cuda.grid_trilinear.launches}


def hold_kernels_on_path():
    """While path T runs, hold each kernel to its plain version on the inputs
    that the path itself hands it: the first call of each new shape (`nn1`:
    query shape and V; `grid_trilinear`: point shape, grid resolution, group)
    has its output compared, on the same tensors, with the plain version's.
    No kernel is launched for the check, so the launch counts stay the path's
    own. A failure is recorded, not raised: the trainer's stages catch and
    print what they raise. Returns ({shape: max abs error}, failures, undo)."""
    import threading

    import torch

    from multiply_tpu_torch.models import renderer as renderer_module
    from multiply_tpu_torch.ops import grid_cuda, skinning

    checked, failures, lock = {}, [], threading.Lock()
    nn1, grid_trilinear = skinning.nn1, renderer_module.grid_trilinear

    def hold(key, compare):
        with lock, torch.no_grad():
            if key in checked:
                return
            try:
                checked[key] = compare()
            except Exception as e:  # noqa: BLE001 - every failure is reported after the run
                checked[key] = math.inf
                failures.append(f"{key}: {e!r}")

    def nn1_held(query, refs):
        d2, idx = nn1(query, refs)
        name = f"path T nn1 query {tuple(query.shape)} V={refs.shape[-2]}"
        hold(("nn1", tuple(query.shape), refs.shape[-2]), lambda: compare_nn1(query, refs, d2, idx, name)[0])
        return d2, idx

    def grid_held(grid, points, origin, spacing, group=1):
        out = grid_trilinear(grid, points, origin, spacing, group=group)

        def compare():
            err = (out - grid_cuda.grid_trilinear_plain(grid, points, origin, spacing, group=group)).abs().max().item()
            assert err <= 1e-5, f"max abs error {err} > 1e-5"
            return err

        hold(("grid_trilinear", tuple(points.shape), grid.shape[-1], group), compare)
        return out

    skinning.nn1, renderer_module.grid_trilinear = nn1_held, grid_held

    def undo():
        skinning.nn1, renderer_module.grid_trilinear = nn1, grid_trilinear

    return checked, failures, undo


def instrument(trainer):
    """Record each training step of `trainer` as (epoch, mode, the mode
    `_select_mode` gives the frame now, loss, update skipped), each opt_depth
    loss, and each pose-loss payload as (built off the main thread, from a
    snapshot, not None). Reading a loss waits for its step."""
    import threading

    steps, depth, payloads = [], [], []
    step, depth_loss, pose_loss_batch = trainer.builder.step, trainer._depth_loss, trainer.pose_loss_batch
    seq = trainer.seq

    def recorded_step(ts, batch, **kw):
        ts, logs = step(ts, batch, **kw)
        certain = bool(seq.smpl_sam_iou[batch.frame_idx] >= seq.uncertain_threshold)
        steps.append((trainer.epoch, batch.mode, trainer._select_mode(certain, True), float(logs["loss"]),
                      float(logs["update_skipped"])))
        return ts, logs

    def recorded_depth_loss(*args, **kw):
        val, parts = depth_loss(*args, **kw)
        depth.append(float(val.detach()))
        return val, parts

    def recorded_pose_loss_batch(frame_idx, rng, params=None):
        out = pose_loss_batch(frame_idx, rng, params=params)
        payloads.append((threading.current_thread() is not threading.main_thread(), params is not None,
                         out is not None))
        return out

    trainer.builder.step = recorded_step
    trainer._depth_loss = recorded_depth_loss
    trainer.pose_loss_batch = recorded_pose_loss_batch
    return steps, depth, payloads


def profile_stages(trainer):
    """Wrap the trainer's epoch and stage methods, and the mesh extraction and
    grid bake it calls, to record (seconds, peak memory) of each call, keyed
    by (name, epoch); returns the record and a function that undoes it."""
    import torch

    import multiply_tpu_torch.engine.trainer as trainer_module

    spent = {}

    def timed(name, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            top = name in STAGE_METHODS
            if top:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            key = (name, trainer.epoch)
            seconds, peak, calls = spent.get(key, (0.0, 0.0, 0))
            now_peak = torch.cuda.max_memory_allocated() / 2**30 if top else 0.0
            spent[key] = (seconds + time.perf_counter() - t0, max(peak, now_peak), calls + 1)
            return out

        return wrapped

    for name in STAGE_METHODS:
        setattr(trainer, name, timed(name, getattr(trainer, name)))
    originals = {name: getattr(trainer_module, name) for name in ("generate_mesh", "sdf_grid")}
    for name, fn in originals.items():
        setattr(trainer_module, name, timed(name, fn))

    def undo():
        for name in STAGE_METHODS:
            delattr(trainer, name)
        for name, fn in originals.items():
            setattr(trainer_module, name, fn)

    return spent, undo


STAGE_METHODS = ("train_epoch", "instance_mask_stage", "validate", "refresh_canonical_state", "opt_depth")


def read_metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_path_t():
    """Path T: the training and test entries' code on the full-scale synthetic
    config, on the card. Returns a dict of what it measured."""
    import numpy as np
    import torch

    from multiply_tpu_torch.cli import test as cli_test
    from multiply_tpu_torch.cli import train as cli_train
    from multiply_tpu_torch.engine.smpl_init import pretrain_smpl_init, sample_training_points, smpl_init_loss
    from multiply_tpu_torch.engine.train import MODE_DELAYED_POSE, MODE_JOINT, MODE_POSE_ONLY
    from multiply_tpu_torch.models.networks import ImplicitNet
    from multiply_tpu_torch.utils.io import read_png

    dev = "cuda"
    run_dir = os.path.join(ROOT, "outputs", "chip_smoke_path_t")
    shutil.rmtree(run_dir, ignore_errors=True)

    def argv(sets, *more):
        return ["--conf", os.path.join(ROOT, TRAIN_CONF), "--run_dir", run_dir, "--device", dev, *more,
                *(f"--set={s}" for s in (*RUN_A_SETS, *sets))]

    mode_names = {MODE_JOINT: "joint", MODE_POSE_ONLY: "pose_only", MODE_DELAYED_POSE: "delayed_pose"}
    t0 = time.perf_counter()
    trainer, conf, ckpt_dir = cli_train.build_trainer(cli_train.parse_args(argv(())))
    setup_s = time.perf_counter() - t0
    m, d = conf.model, conf.dataset.train
    widths = (f"SDF {len(m.implicit_network.dims)}x{m.implicit_network.dims[0]}, render "
              f"{len(m.rendering_network.dims)}x{m.rendering_network.dims[0]}, sampler "
              f"{m.ray_sampler.max_total_iters}x{m.ray_sampler.N_samples_eval} evals (bf16 {m.sampler_bf16}), "
              f"{d.num_sample} rays a step, {d.height}x{d.width} images, {len(trainer.seq)} frames")
    assert list(m.implicit_network.dims) == [256] * 8 and list(m.rendering_network.dims) == [256] * 4, widths
    assert (m.ray_sampler.max_total_iters, m.ray_sampler.N_samples_eval, d.num_sample) == (5, 128, 512), widths
    assert (d.height, d.width, bool(m.sampler_bf16), bool(m.depth_end)) == (270, 360, True, True), widths
    log(f"path T: set-up {setup_s:.1f} s ({widths})")

    # ---- run A: epochs 0..20 ----
    held_shapes, failures, unhold = hold_kernels_on_path()
    steps_a, depth_a, _ = instrument(trainer)
    spent, undo = profile_stages(trainer)
    grid_before = trainer.person_state.cano_grid["grid"].clone()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit(EPOCHS_A, ckpt_dir=ckpt_dir)
    torch.cuda.synchronize()
    fit_a_s = time.perf_counter() - t0
    launches_a = read_counts()
    undo()
    peak_a = max(peak for _, peak, _ in spent.values())
    assert min(launches_a.values()) > 0, f"path T run A launched {launches_a}"
    grid_after = trainer.person_state.cano_grid["grid"]
    assert trainer.builder.state.cano_grid["grid"] is grid_after, "the step does not read the refreshed grid"
    for p in range(grid_after.shape[0]):
        assert not torch.equal(grid_before[p], grid_after[p]), f"mesh refresh left person {p}'s grid as it was"
    n_frames = len(trainer.seq)
    assert len(steps_a) == EPOCHS_A * n_frames, f"run A took {len(steps_a)} steps"
    for ep, mode, expected, loss, skipped in steps_a:
        assert mode == expected, f"epoch {ep}: step mode {mode}, _select_mode gives {expected}"
        assert math.isfinite(loss) and skipped == 0.0, f"epoch {ep}: loss {loss}, update skipped {skipped}"
    assert len(depth_a) == n_frames * trainer.it_per_loop, f"opt_depth ran {len(depth_a)} iterations"
    assert all(math.isfinite(v) for v in depth_a), f"opt_depth losses {depth_a}"
    expected_files = [
        "stage_instance_mask/00000/all_person_smpl_mask.npy", "stage_instance_mask/00000/2d_keypoint.npy",
        "stage_sam_mask/00000/sam_opt_mask.npy", "val/epoch_00000.png", "checkpoints/epoch_00000",
        "checkpoints/last", *(f"val/epoch_00000_person_{p}.ply" for p in range(trainer.num_person)),
        *(f"stage_depth_map/{EPOCHS_A - 1:05d}/{it:05d}/{kind}/{kind}_{f:04d}.png"
          for it in (0, trainer.it_per_loop - 1) for kind in ("front", "gt") for f in range(n_frames)),
    ]
    missing = [f for f in expected_files if not os.path.exists(os.path.join(run_dir, f))]
    assert not missing, f"path T run A did not write {missing}"
    metrics = read_metrics(run_dir)
    epoch_s = {r["epoch"]: r["epoch_seconds"] for r in metrics if "epoch_seconds" in r}
    stage_s = {f"{k[:-8]}@{r['epoch']}": r[k] for r in metrics for k in r if k.endswith("_seconds") and k != "epoch_seconds"}
    psnr = [r["val_psnr"] for r in metrics if "val_psnr" in r]
    assert psnr and all(math.isfinite(v) for v in psnr), f"validation PSNR {psnr}"
    staged = {int(k.split("@")[1]) for k in stage_s}
    plain_epochs = [s for ep, s in epoch_s.items() if ep not in staged and ep != 0]
    modes_a = {name: sum(1 for s in steps_a if s[1] == mode) for mode, name in mode_names.items()}

    # ---- run B: a fresh trainer resumed from `last`, one pose-only epoch ----
    trainer_b, _, _ = cli_train.build_trainer(cli_train.parse_args(argv(RUN_B_SETS)))
    trainer_b.load_checkpoint(os.path.join(ckpt_dir, "last"))
    pa, pb = trainer.ts.params(), trainer_b.ts.params()
    assert all(torch.equal(pa[k], pb[k]) for k in pa), "resumed parameters differ"
    for name in ("opt_joint", "opt_pose"):
        sa, sb = getattr(trainer.ts, name), getattr(trainer_b.ts, name)
        assert sa.count == sb.count, f"resumed {name} step counts differ"
        assert all(torch.equal(sa.mu[k], sb.mu[k]) and torch.equal(sa.nu[k], sb.nu[k]) for k in sa.mu), name
    assert trainer_b.epoch == trainer.epoch == EPOCHS_A, (trainer_b.epoch, trainer.epoch)
    steps_b, _, payloads = instrument(trainer_b)
    zero_counts()
    t0 = time.perf_counter()
    trainer_b.fit(EPOCHS_A + 1, ckpt_dir=ckpt_dir)
    torch.cuda.synchronize()
    fit_b_s = time.perf_counter() - t0
    launches_b = read_counts()
    assert min(launches_b.values()) > 0, f"path T run B launched {launches_b}"
    assert len(steps_b) == n_frames and all(s[1] == s[2] == MODE_POSE_ONLY for s in steps_b), steps_b
    assert all(math.isfinite(s[3]) and s[4] == 0.0 for s in steps_b), steps_b
    assert payloads == [(True, True, True)] * n_frames, f"pose-loss payloads {payloads}"

    # ---- the learned-mesh instance masks, SMPL init, the test entry ----
    t0 = time.perf_counter()
    trainer_b.instance_mask_stage(epoch=LEARNED_MESH_EPOCH)
    learned_mask_s = time.perf_counter() - t0
    learned = np.load(os.path.join(run_dir, "stage_instance_mask", f"{LEARNED_MESH_EPOCH:05d}",
                                   "all_person_smpl_mask.npy"))
    assert learned.shape[:2] == (n_frames, trainer_b.num_person) and learned.any(), learned.shape

    net = ImplicitNet.from_config(conf.model.implicit_network, device=dev,
                                  generator=torch.Generator(dev).manual_seed(SEED))
    pts, gt = sample_training_points(trainer_b.servers[0], 4096, np.random.default_rng(SEED))
    held = (torch.as_tensor(pts, device=dev), torch.as_tensor(gt, device=dev), torch.zeros((4096, 3), device=dev))
    loss0 = float(smpl_init_loss(net, *held)[0].detach())
    t0 = time.perf_counter()
    pretrain_smpl_init(net, trainer_b.servers[0], steps=SMPL_INIT_STEPS)
    torch.cuda.synchronize()
    smpl_init_s = time.perf_counter() - t0
    loss1 = float(smpl_init_loss(net, *held)[0].detach())
    assert math.isfinite(loss1) and loss1 < loss0, f"SMPL init loss {loss0} -> {loss1}"

    t0 = time.perf_counter()
    test_dir = cli_test.main(["--conf", os.path.join(ROOT, TRAIN_CONF), "--run_dir", run_dir, "--device", dev,
                              "--frames", "1", *(f"--set={s}" for s in RUN_A_SETS)])
    test_s = time.perf_counter() - t0
    img = read_png(os.path.join(test_dir, "test_rendering", "0000.png"))
    assert img.shape == (d.height, 2 * d.width, 3), img.shape
    unhold()
    assert not failures, f"path T: a kernel disagrees with its plain version: {failures}"
    held_err = {k: max((e for key, e in held_shapes.items() if key[0] == k), default=None)
                for k in ("nn1", "grid_trilinear")}
    assert all(e is not None for e in held_err.values()), f"path T held no call of {held_err}"

    # a peak is read per stage method; the extractions and bakes inside one show None
    breakdown = {f"{name}@{ep}": (round(sec, 3), round(peak, 3) if name in STAGE_METHODS else None, calls)
                 for (name, ep), (sec, peak, calls) in spent.items() if name != "train_epoch"}
    epochs_peak = max(peak for (name, _), (_, peak, _) in spent.items() if name == "train_epoch")
    per_frame = trainer.it_per_loop
    depth_by_frame = [(depth_a[f * per_frame], depth_a[(f + 1) * per_frame - 1]) for f in range(n_frames)]
    out = {
        "setup_s": setup_s, "fit_a_s": fit_a_s, "fit_b_s": fit_b_s, "epoch_s": epoch_s,
        "epoch_median_s": median(plain_epochs), "stage_s": stage_s, "learned_mask_s": learned_mask_s,
        "smpl_init_s": smpl_init_s, "smpl_init_loss": (loss0, loss1), "test_s": test_s,
        "modes_a": modes_a, "modes_b": {name: sum(1 for s in steps_b if s[1] == mode) for mode, name in mode_names.items()},
        "launches_a": launches_a, "launches_b": launches_b, "peak_gib": peak_a, "val_psnr": psnr,
        "steps_a": len(steps_a), "steps_b": len(steps_b), "opt_depth_by_frame": depth_by_frame,
        "breakdown": breakdown, "epochs_peak_gib": epochs_peak, "held": held_shapes, "held_err": held_err,
    }
    log(f"path T run A: {EPOCHS_A} epochs in {fit_a_s:.1f} s, median epoch without a stage "
        f"{out['epoch_median_s']:.3f} s (epoch 0 {epoch_s[0]:.3f} s), stages (seconds @ epoch) "
        f"{ {k: round(v, 3) for k, v in stage_s.items()} }, steps per mode {modes_a}, launches over the fit "
        f"{launches_a}, peak memory {out['peak_gib']:.3f} GiB (epochs alone {epochs_peak:.3f}), validation PSNR "
        f"{psnr}, opt_depth loss first -> last iteration by frame "
        f"{[(round(a, 5), round(b, 5)) for a, b in depth_by_frame]}")
    log(f"path T run A, (seconds, peak GiB, calls) @ epoch of each stage and of the mesh extractions and grid "
        f"bakes inside them: {breakdown}")
    log(f"path T run B (resumed from last, params/Adam/epoch equal): {len(steps_b)} pose-only steps in "
        f"{fit_b_s:.1f} s, payloads from the producer's snapshot, launches {launches_b}; learned-mesh instance "
        f"masks {learned_mask_s:.1f} s; SMPL init {SMPL_INIT_STEPS} steps {smpl_init_s:.1f} s (held-out loss "
        f"{loss0:.5f} -> {loss1:.5f}); test entry, 1 frame, {test_s:.1f} s")
    log(f"path T: each kernel held to its plain version on the first call of each shape it was given, max abs "
        f"error by shape: { {' '.join(map(str, k)): float(f'{e:.3g}') for k, e in held_shapes.items()} }")
    return out


def sam_encoder_flops(variant, img=1024, window=14):
    """Multiply-adds x 2 of one image through the ViT encoder at this input:
    the windowed blocks' qkv and projection on the padded grid, the MLPs on the
    unpadded one, attention and its rel-pos terms per window or over the grid,
    the patch embedding and the neck (norms, softmax and GELU not counted)."""
    from multiply_tpu_torch.models.sam import VIT_CONFIGS

    cfg = VIT_CONFIGS[variant]
    C, g = cfg["embed_dim"], img // 16
    T, padded = g * g, -(-g // window) * window
    n_win, w2 = (padded // window) ** 2, window * window
    flops = 2 * T * C * 3 * 16 * 16 + 2 * T * C * 256 + 2 * T * 256 * 256 * 9
    for i in range(cfg["depth"]):
        tokens = T if i in cfg["global_attn"] else padded * padded
        flops += 2 * tokens * C * 4 * C + 2 * T * C * 8 * C  # qkv + proj, MLP
        if i in cfg["global_attn"]:
            flops += 4 * T * T * C + 4 * T * g * C  # logits + attn @ v, two rel-pos einsums
        else:
            flops += n_win * (4 * w2 * w2 * C + 4 * w2 * window * C)
    return flops


def run_path_s():
    """Path S: the SAM refinement path. (a) `random_sam` at vit_h width with
    random `pos_embed` and rel-pos tables, saved in the official layout; the
    model turns TF32 off as it is built, even where it was on; (b) one frame
    encoded in f32, in float64 and with TF32 allowed, the f32 error held to
    SAM_F64_TOL and below TF32's; encode and predict timed; (c) the training
    entry's code with `--set sam_checkpoint=<file>` for epochs 0-1: the stage
    must be `SamSegmenter`, write (F, P, H, W) finite logits that the sequence
    picks up, and each step of both epochs must train in the mode
    `_select_mode` gives, on finite losses. Returns a dict of what it
    measured."""
    import copy

    import numpy as np
    import torch

    from multiply_tpu_torch.cli import train as cli_train
    from multiply_tpu_torch.engine.instance_masks import build_sam_prompts
    from multiply_tpu_torch.engine.sam_stage import SamSegmenter
    from multiply_tpu_torch.models import sam as sam_model
    from multiply_tpu_torch.utils.logging import profile_trace
    from multiply_tpu_torch.utils.profiling import summarize_trace

    dev, variant = "cuda", SAM_VARIANT
    run_dir = os.path.join(ROOT, "outputs", "chip_smoke_path_s")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    ckpt = os.path.join(run_dir, f"sam_{variant}_random.pth")
    out = {}
    try:
        # ---- (a) weights ----
        t0 = time.perf_counter()
        gen = torch.Generator(dev).manual_seed(SEED)
        # cuDNN's own default: the model, not an earlier phase, must turn TF32 off
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        model = sam_model.random_sam(variant, gen, device=dev)
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        assert flags == (False, False), f"TF32 (matmul, cuDNN) {flags} after building the SAM model"
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("pos_embed", "rel_pos_h", "rel_pos_w")):
                    p.normal_(0.0, 0.02, generator=gen)
        torch.save(model.state_dict(), ckpt)
        out["n_params_encoder"] = sum(p.numel() for p in model.image_encoder.parameters())
        out["n_params"] = sum(p.numel() for p in model.parameters())
        out["weights_s"] = time.perf_counter() - t0
        log(f"path S: {variant} ({out['n_params_encoder'] / 1e6:.3f} M encoder parameters, "
            f"{out['n_params'] / 1e6:.3f} M in all) built and saved in the official layout in "
            f"{out['weights_s']:.1f} s ({os.path.getsize(ckpt) / 2**30:.3f} GiB)")

        # ---- (b) one frame: f32 against float64 and TF32; times ----
        pred = sam_model.SamPredictor(model)
        frame = (np.random.default_rng(SEED).random((270, 360, 3)) * 255).astype(np.uint8)
        x = pred.preprocess(frame)
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            e32 = model.encode_image(x)
            torch.cuda.synchronize()
            out["encode_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out["encode_ms"] = cuda_time_ms(lambda: model.encode_image(x), reps=5, warmup=1)
            flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                e_tf32 = model.encode_image(x)
                out["encode_tf32_ms"] = cuda_time_ms(lambda: model.encode_image(x), reps=5, warmup=1)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            enc64 = copy.deepcopy(model.image_encoder).double()
            e64 = enc64(x.double())
            del enc64
            err32 = (e32.double() - e64).abs().max().item()
            err_tf32 = (e_tf32.double() - e64).abs().max().item()
            scale = e64.abs().max().item()
        assert e32.shape == (1, 64, 64, 256) and torch.isfinite(e32).all(), tuple(e32.shape)
        out.update(err_f32=err32, err_tf32=err_tf32, out_max=scale)
        log(f"path S encode: max |f32 - f64| {err32:.3g}, max |tf32 - f64| {err_tf32:.3g} (output max |f64| "
            f"{scale:.3g}); tolerance {SAM_F64_TOL}; with TF32 allowed (not used) {out['encode_tf32_ms']:.2f} ms")
        assert err32 <= SAM_F64_TOL, f"SAM encoder f32 differs from f64 by {err32} > {SAM_F64_TOL}"
        assert err_tf32 > SAM_F64_TOL, f"TF32 passes the f64 check ({err_tf32}): the tolerance tells nothing"
        del e_tf32, e64

        # one predict with the prompts the stage would build, on the encoded frame
        pred.set_image(frame)
        masks = np.zeros((2, 270, 360), bool)
        masks[0, 60:250, 40:170], masks[1, 50:240, 190:330] = True, True
        kps = np.stack([np.stack([np.linspace(50, 160, 27), np.linspace(70, 240, 27)], -1),
                        np.stack([np.linspace(200, 320, 27), np.linspace(60, 230, 27)], -1)]).astype(np.int32)
        pr = build_sam_prompts(masks, kps, np.random.default_rng(SEED))[0]
        low = pred.predict(pr["points"], pr["labels"], pr["box"], pr["mask_prior_logits"])
        assert low.shape == (256, 256) and np.isfinite(low).all(), low.shape

        def predict():
            return pred.predict(pr["points"], pr["labels"], pr["box"], low)

        out["predict_ms"] = cuda_time_ms(predict, reps=20, warmup=2)
        # where an encode's and a predict's time goes: kernels by category, wall against device busy
        with torch.inference_mode():
            trace_dir = os.path.join(run_dir, "encode_trace")
            with profile_trace(trace_dir):
                model.encode_image(x)
                torch.cuda.synchronize()
            out["encode_categories"] = summarize_trace(trace_dir)
            wall_e, busy_e, rows_e, _, n_e, _ = step_breakdown(lambda: model.encode_image(x), top=6)
        wall_p, busy_p, _, _, n_p, _ = step_breakdown(predict, top=1)
        out.update(encode_wall_ms=wall_e, encode_busy_ms=busy_e, encode_launches=n_e, predict_wall_ms=wall_p,
                   predict_busy_ms=busy_p, predict_launches=n_p)
        log(f"path S profiled encode: wall {wall_e:.2f} ms, device busy {busy_e:.2f} ms, {n_e} launches; by category "
            f"{[(r['category'], round(r['total_ms'], 3), r['count']) for r in out['encode_categories']]}; top kernels:")
        for name, ms, count in rows_e:
            log(f"  {ms:9.3f} ms  x{count:<5d} {name}")
        log(f"path S profiled predict: wall {wall_p:.3f} ms, device busy {busy_p:.3f} ms, {n_p} launches")
        flops = sam_encoder_flops(variant)
        out.update(encoder_flops=flops, encoder_bound_ms=flops / PEAK_FP32_FLOPS * 1e3)
        log(f"path S: encode {out['encode_ms']:.2f} ms a frame (CUDA events, median of 5; bound "
            f"{out['encoder_bound_ms']:.2f} ms = {flops / 1e12:.4f} TFLOP at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s f32, "
            f"by operations), peak memory {out['encode_peak_gib']:.3f} GiB; predict {out['predict_ms']:.3f} ms a call "
            f"({len(pr['points'])} points + box, mask input)")
        del model, pred, e32, x
        torch.cuda.empty_cache()

        # ---- (c) the training entry with the checkpoint, epochs 0-1 ----
        argv = ["--conf", os.path.join(ROOT, TRAIN_CONF), "--run_dir", run_dir, "--device", dev,
                *(f"--set={s}" for s in (*RUN_A_SETS, f"sam_checkpoint={ckpt}"))]
        t0 = time.perf_counter()
        trainer, _, _ = cli_train.build_trainer(cli_train.parse_args(argv))
        out["setup_s"] = time.perf_counter() - t0
        seg = trainer.segmenter
        assert isinstance(seg, SamSegmenter), f"the SAM stage is {type(seg).__name__}"
        calls = []
        predict_fn = seg.predictor.predict

        def counted(*args, **kw):
            calls.append(1)
            return predict_fn(*args, **kw)

        seg.predictor.predict = counted
        sam_stage = trainer.sam_stage

        def measured_sam_stage(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            result = sam_stage(*args, **kw)
            torch.cuda.synchronize()
            out["stage_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            return result

        trainer.sam_stage = measured_sam_stage
        steps, _, _ = instrument(trainer)
        zero_counts()
        t0 = time.perf_counter()
        trainer.fit(SAM_EPOCHS, render_val=False)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["launches"] = read_counts()
        assert min(out["launches"].values()) > 0, f"path S launched {out['launches']}"
        n_frames, n_persons = len(trainer.seq), trainer.num_person
        sam_file = os.path.join(run_dir, "stage_sam_mask", "00000", "sam_opt_mask.npy")
        refined = np.load(sam_file)
        H, W = trainer.seq.get_eval_item(0)["img_size"]
        assert refined.shape == (n_frames, n_persons, H, W) and np.isfinite(refined).all(), refined.shape
        assert len(calls) == 3 * n_frames * n_persons, f"{len(calls)} predict calls"
        assert len(steps) == SAM_EPOCHS * n_frames, f"path S took {len(steps)} steps"
        for ep, mode, expected, loss, skipped in steps:
            assert mode == expected, f"path S epoch {ep}: step mode {mode}, _select_mode gives {expected}"
            assert math.isfinite(loss) and skipped == 0.0, f"path S epoch {ep}: loss {loss}, update skipped {skipped}"
        seq = trainer.seq
        assert seq._sam_path == sam_file and np.array_equal(seq._sam_masks, refined.transpose(0, 2, 3, 1)), \
            "the sequence did not pick the refined masks up"
        metrics = read_metrics(run_dir)
        sam_s = [r["sam_seconds"] for r in metrics if "sam_seconds" in r]
        losses = {r["epoch"]: r["loss"] for r in metrics if "loss" in r and "epoch_seconds" in r}
        assert len(sam_s) == 1 and math.isfinite(losses[1]), (sam_s, losses)
        out.update(sam_stage_s=sam_s[0], losses=losses, shape=refined.shape, predict_calls=len(calls), steps=len(steps),
                   modes=[(ep, mode) for ep, mode, *_ in steps],
                   positive_share=float((refined > 0).mean()))
        log(f"path S: entry set-up {out['setup_s']:.1f} s (checkpoint loaded strictly), epochs 0-{SAM_EPOCHS - 1} in "
            f"{out['fit_s']:.1f} s; SAM stage {out['sam_stage_s']:.3f} s (metrics.jsonl) for {n_frames} frames x "
            f"{n_persons} persons ({len(calls)} predict calls), peak memory {out['stage_peak_gib']:.3f} GiB; "
            f"sam_opt_mask {refined.shape}, finite, {out['positive_share']:.3f} of it positive, picked up by the "
            f"sequence; {len(steps)} steps, (epoch, mode) {out['modes']}; epoch losses {losses}; kernel launches "
            f"{out['launches']}")
        del trainer, seg, seq
    finally:
        if os.path.exists(ckpt):
            os.remove(ckpt)
    torch.cuda.empty_cache()
    return out


def run_profile():
    """`cli/train.py --profile N` on path T's configuration: its table, read
    back from `<run_dir>/profile/summary.json`."""
    from multiply_tpu_torch.cli import train as cli_train

    run_dir = os.path.join(ROOT, "outputs", "chip_smoke_profile")
    shutil.rmtree(run_dir, ignore_errors=True)
    cli_train.main(["--conf", os.path.join(ROOT, TRAIN_CONF), "--run_dir", run_dir, "--device", "cuda",
                    "--profile", str(PROFILE_STEPS), *(f"--set={s}" for s in RUN_A_SETS)])
    with open(os.path.join(run_dir, "profile", "summary.json")) as f:
        summary = json.load(f)
    cats = {r["category"] for r in summary["rows"]}
    assert summary["steps"] == PROFILE_STEPS and {"gemm", "nn1_kernel", "grid_trilinear_kernel"} <= cats, summary
    return summary


def main() -> int:
    import torch

    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from multiply_tpu_torch import cuda_build
    from multiply_tpu_torch.config import load_config
    from multiply_tpu_torch.data.synthetic import make_scene
    from multiply_tpu_torch.engine.train import MODE_POSE_ONLY, TrainStep
    from multiply_tpu_torch.models.loss import LossConfig
    from multiply_tpu_torch.models.renderer import MultiplyRenderer, RenderInputs
    from multiply_tpu_torch.ops import grid_cuda, knn_cuda
    from multiply_tpu_torch.utils.cameras import pixel_grid

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    # ---------------- 2. build ----------------
    from multiply_tpu_torch import native

    libs = (*cuda_build.KERNELS, *cuda_build.VARIANTS)
    build_s, build_logs = cuda_build.build_all(libs)
    t0 = time.perf_counter()
    native._lib()  # the host C++ of path T
    log(f"build: {build_s:.1f} s for {', '.join(libs)}; native host library {cuda_build.BUILD_DIR}/libmultiply_host.so "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for name in ("nn1", "nn1_exact"):
        sass = sass_inner_loop(os.path.join(cuda_build.BUILD_DIR, f"lib{name}.so"), "nn1_kernel")
        log(f"  sass {name} inner loop: {sass}")

    # ---------------- 3. set-up ----------------
    dev = "cuda"
    t0 = time.perf_counter()
    conf = load_config(os.path.join(ROOT, "confs", "model", "taichi01_model.yaml"))
    P, F_ = 2, 4
    scene = make_scene(num_frames=F_, num_persons=P, height=32, width=40, seed=SEED, device=dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    renderer = MultiplyRenderer(conf, num_persons=P, num_frames=F_, generator=gen, device=dev)
    state = renderer.build_person_state(scene.servers, grid_res=64)
    stepper = TrainStep(renderer, state, LossConfig(sam_start_epoch=0),
                        learning_rate=conf.learning_rate)
    ts = stepper.init_state(body_tables(scene, dev))
    torch.cuda.synchronize()
    log(f"setup: scene + grid bake (res 64) {time.perf_counter() - t0:.1f} s")

    # ---------------- 4. kernels vs plain, on the card ----------------
    cfg = renderer.sampler_cfg
    n_sampler = RAYS * cfg.N_samples_eval  # one sampler round, per person
    S = cfg.N_samples + cfg.N_samples_extra + 1  # render samples per ray
    n_render = RAYS * S
    kgen = torch.Generator(dev).manual_seed(SEED + 1)
    with torch.no_grad():
        verts = state.server.verts_c.contiguous()  # (2, 386, 3)
        lo, hi = verts.min(1, keepdim=True).values, verts.max(1, keepdim=True).values
        q = lo - 0.3 + (hi - lo + 0.6) * torch.rand((P, n_sampler, 3), generator=kgen, device=dev)
        err_a, nd_a = check_nn1(q, verts, "nn1 P=2 V=386")
        err_a3, nd_a3 = check_nn1(q[:, :RAYS].contiguous(), verts, f"nn1 P=2 N={RAYS} V=386")
        # what a pose-only step's forward warp hands the kernel: the padded
        # meshes, most of whose vertices repeat the last real one
        q_mesh = pose_loss_batch(scene, 0, np.random.default_rng(SEED), dev).verts_c.contiguous()
        err_a4, nd_a4 = check_nn1(q_mesh, verts, f"nn1 P=2 N={MESH_BUCKET} V=386 (padded pose meshes)")
        refs_big = torch.randn((6890, 3), generator=kgen, device=dev) * 0.4
        q_big = torch.randn((n_sampler, 3), generator=kgen, device=dev) * 0.5
        err_a2, nd_a2 = check_nn1(q_big, refs_big, "nn1 V=6890")
        log(f"nn1: max|d2 err| {err_a:.3g} (V=386, {nd_a} tie swaps), {err_a3:.3g} (N={RAYS}, "
            f"{nd_a3} tie swaps), {err_a4:.3g} (padded pose meshes, N={MESH_BUCKET}, {nd_a4} tie swaps), "
            f"{err_a2:.3g} (V=6890, {nd_a2} tie swaps); exact build bit-identical")

        g = state.cano_grid
        res = g["grid"].shape[-1]
        glo = g["origin"][:, None, :]
        ghi = glo + g["spacing"][:, None, :] * (res - 1)
        pts = glo - 0.1 + (ghi - glo + 0.2) * torch.rand((P, n_render, 3), generator=kgen, device=dev)
        grid_args = (g["grid"], pts, g["origin"], g["spacing"])
        err_b1 = (grid_cuda.grid_trilinear_kernel(*grid_args)
                  - grid_cuda.grid_trilinear_plain(*grid_args)).abs().max().item()
        fused_k = grid_cuda.grid_trilinear_kernel(*grid_args, group=S)
        assert fused_k.shape == (P, RAYS), f"grid_trilinear fused: shape {tuple(fused_k.shape)}"
        err_b = (fused_k - grid_cuda.grid_trilinear_plain(*grid_args, group=S)).abs().max().item()
        assert err_b1 <= 1e-5, f"grid_trilinear group=1: max abs error {err_b1} > 1e-5"
        assert err_b <= 1e-5, f"grid_trilinear group={S}: max abs error {err_b} > 1e-5"
        log(f"grid_trilinear: max abs err {err_b1:.3g} (group=1), {err_b:.3g} (group={S})")

        def run_a():
            return knn_cuda.nn1_kernel(q, verts)

        def run_a2():
            return knn_cuda.nn1_kernel(q_big, refs_big)

        def run_b():
            return grid_cuda.grid_trilinear_kernel(*grid_args, group=S)

        def run_b1():
            return grid_cuda.grid_trilinear_kernel(*grid_args)

        t_a = cuda_time_ms(run_a)
        t_a_exact = cuda_time_ms(lambda: knn_cuda.nn1_kernel(q, verts, exact=True))
        t_a_plain = cuda_time_ms(lambda: knn_cuda.nn1_plain(q, verts), reps=20)
        t_a_lib = cuda_time_ms(
            lambda: torch.cdist(q, verts, compute_mode="donot_use_mm_for_euclid_dist").min(-1), reps=20
        )
        t_a4 = cuda_time_ms(lambda: knn_cuda.nn1_kernel(q_mesh, verts))
        t_a2 = cuda_time_ms(run_a2, reps=20)
        t_a2_exact = cuda_time_ms(lambda: knn_cuda.nn1_kernel(q_big, refs_big, exact=True), reps=20)
        t_a2_plain = cuda_time_ms(lambda: knn_cuda.nn1_plain(q_big, refs_big), reps=20)
        t_b = cuda_time_ms(run_b)
        t_b1 = cuda_time_ms(run_b1)
        t_b_plain = cuda_time_ms(lambda: grid_cuda.grid_trilinear_plain(*grid_args, group=S))
        unit = (pts - glo) / g["spacing"][:, None, :] / (res - 1) * 2 - 1  # align_corners=True coords
        vol = g["grid"][:, None]  # (P, 1, X, Y, Z): grid_sample's (x, y, z) index (Z, Y, X)
        t_b_lib = cuda_time_ms(  # the same function: interpolate, then the least of each ray
            lambda: F.grid_sample(vol, unit.flip(-1)[:, None, None], mode="bilinear", padding_mode="border",
                                  align_corners=True).reshape(P, RAYS, S).min(-1)
        )
        (host_a, host_a_best), (host_b, host_b_best) = host_time_us(run_a), host_time_us(run_b)
        dev_a, n_a = device_time_ms(run_a, "nn1_kernel")
        dev_a2, _ = device_time_ms(run_a2, "nn1_kernel")
        dev_a_exact, _ = device_time_ms(lambda: knn_cuda.nn1_kernel(q, verts, exact=True), "nn1_kernel")
        dev_a2_exact, _ = device_time_ms(lambda: knn_cuda.nn1_kernel(q_big, refs_big, exact=True), "nn1_kernel")
        dev_b, n_b = device_time_ms(run_b, "grid_trilinear_kernel")
        dev_b1, n_b1 = device_time_ms(run_b1, "grid_trilinear_kernel")
    log(f"device time (profiler): nn1 {dev_a} ms (exact build {dev_a_exact}), at V=6890 {dev_a2} ms "
        f"(exact build {dev_a2_exact}); grid_trilinear fused {dev_b} ms, group=1 {dev_b1} ms")
    log(f"host time of one wrapper call: nn1 {host_a:.2f} us (fastest batch {host_a_best:.2f}), "
        f"grid_trilinear {host_b:.2f} us (fastest batch {host_b_best:.2f})")
    log(f"device kernels per wrapper call (profiler): nn1 {n_a}, grid_trilinear fused {n_b}, group=1 {n_b1}")
    assert n_a == n_b == n_b1 == 1, "a kernel wrapper launched more than its one kernel"

    V = verts.shape[1]
    a_ops = NN1_OPS_PER_PAIR * P * n_sampler * V
    a_bytes = P * (n_sampler * 12 + V * 12 + n_sampler * 12)  # d2 f32 + idx i64 out
    b_bytes = P * (n_render * 12 + res**3 * 4 + 24 + RAYS * 4)  # the fused form writes one value a ray
    b_ops = (GRID_OPS_PER_POINT + 1) * P * n_render  # + the running minimum
    bound_a = max(a_ops / PEAK_FP32_FLOPS, a_bytes / PEAK_BYTES) * 1e3
    bound_b = max(b_ops / PEAK_FP32_FLOPS, b_bytes / PEAK_BYTES) * 1e3
    bound_a2 = NN1_OPS_PER_PAIR * n_sampler * 6890 / PEAK_FP32_FLOPS * 1e3
    log(f"nn1 at V=6890, N={n_sampler}: kernel {t_a2:.4f} ms (exact build {t_a2_exact:.4f}), "
        f"plain {t_a2_plain:.4f} ms, bound {bound_a2:.4f} ms (operations)")
    log(f"nn1 exact build at V=386: kernel {t_a_exact:.4f} ms against {t_a:.4f}")
    log(f"nn1 on the padded pose meshes, N={MESH_BUCKET}, V={V}: kernel {t_a4:.4f} ms")

    # ---------------- 5. training: the port's main path ----------------
    rng = np.random.default_rng(SEED)
    before = {k: p.detach().clone() for k, p in ts.params().items()}

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    ts, step_s, _ = run_steps("parity", stepper, ts, [make_batch(scene, i % F_, rng, dev) for i in range(STEPS)], gen)
    launches = read_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    assert launches["nn1"] == 8 * STEPS, f"nn1 launched {launches['nn1']} times in {STEPS} steps"
    assert launches["grid_trilinear"] == STEPS, f"grid_trilinear launched {launches['grid_trilinear']} times"
    # every leaf moves except the pose-embedding weight, whose input (the pose
    # conditioning) is zero before epoch 20, so its gradient is exactly zero
    unchanged = {k for k, p in ts.params().items() if torch.equal(p, before[k])}
    assert unchanged <= {"net.fg_render.lin_pose.weight"}, f"params unchanged: {unchanged}"
    med = median(step_s[1:])
    log(f"train (parity preset): median step {med * 1e3:.2f} ms ({RAYS / med:.1f} rays/s) over steps "
        f"1..{STEPS - 1}, range {min(step_s[1:]) * 1e3:.2f}-{max(step_s[1:]) * 1e3:.2f} ms, "
        f"step 0 {step_s[0] * 1e3:.1f} ms, peak memory {peak_mem / 2**30:.3f} GiB")

    # where one more step's time goes (after the counts were read)
    batch = make_batch(scene, STEPS % F_, rng, dev)
    wall, busy, rows, n_names, n_launch, gemms = step_breakdown(lambda: stepper.step(ts, batch, generator=gen))
    log(f"profiled step: wall {wall:.2f} ms, device busy {busy:.2f} ms (idle share "
        f"{1 - busy / wall:.3f}), {n_launch} kernel launches of {n_names} kinds ({LAUNCHES_BEFORE} "
        f"before the kernels' wrappers were thinned); top by device time, then the two ported kernels:")
    for name, ms, count in rows:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name}")
    parity = {"median_ms": med * 1e3, "busy_ms": busy, "wall_ms": wall, "launches": n_launch,
              "gemm_ms": gemm_summary(gemms), "peak_gib": peak_mem / 2**30}

    # full-frame render, train=False, in 512-ray chunks
    uv = torch.as_tensor(pixel_grid(scene.width, scene.height), device=dev)
    body = ts.body
    rgb = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for chunk in uv.split(RAYS):
            inputs = RenderInputs(
                uv=chunk, pose=torch.as_tensor(scene.cam_pose[0], device=dev),
                intrinsics=torch.as_tensor(scene.intrinsics, device=dev),
                scale=torch.as_tensor(scene.scale, device=dev), transl=body.transl[:, 0],
                thetas=body.thetas(0), betas=body.betas[:, 0], frame_idx=0, epoch=ts.epoch,
            )
            rgb.append(renderer.render(state, inputs, train=False)["rgb_values"])
    rgb = torch.cat(rgb).reshape(scene.height, scene.width, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(rgb).all(), "non-finite rendered frame"
    mse = ((rgb.cpu().numpy() - scene.images[0]) ** 2).mean()
    log(f"render: {scene.height}x{scene.width} frame in {time.perf_counter() - t0:.2f} s, "
        f"PSNR {-10 * math.log10(mse):.3f} dB after {STEPS} steps")

    # ---------------- 6. path F: the fast preset ----------------
    conf_f = load_config(
        os.path.join(ROOT, "confs", "taichi01_base.yaml"),
        overrides={"model": load_config(os.path.join(ROOT, "confs", "model", "taichi01_fast_model.yaml")).to_dict()},
    ).model
    conf_f["num_training_frames"] = F_
    conf_f["implicit_network"]["number_person"] = P
    assert conf_f.sampler_bf16 and conf_f.bbox_ray_range, "the fast preset did not load"
    gen_f = torch.Generator(dev).manual_seed(SEED)  # the same initial weights as the parity preset
    renderer_f = MultiplyRenderer(conf_f, num_persons=P, num_frames=F_, generator=gen_f, device=dev)
    stepper_f = TrainStep(renderer_f, state, LossConfig(sam_start_epoch=0), learning_rate=conf_f.learning_rate)
    ts_f = stepper_f.init_state(body_tables(scene, dev))
    rng_f = np.random.default_rng(SEED)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    ts_f, step_f, _ = run_steps("fast", stepper_f, ts_f,
                                [make_batch(scene, i % F_, rng_f, dev) for i in range(STEPS_FAST)], gen_f)
    launches_f = read_counts()
    peak_f = torch.cuda.max_memory_allocated()
    assert launches_f == {"nn1": 8 * STEPS_FAST, "grid_trilinear": STEPS_FAST}, f"fast preset launches {launches_f}"
    batch = make_batch(scene, STEPS_FAST % F_, rng_f, dev)
    wall_f, busy_f, _, _, n_launch_f, gemms_f = step_breakdown(
        lambda: stepper_f.step(ts_f, batch, generator=gen_f))
    med_f = median(step_f[1:])
    bf16_f, other_f = gemm_summary(gemms_f)
    log(f"train (fast preset): median step {med_f * 1e3:.2f} ms ({RAYS / med_f:.1f} rays/s) over steps "
        f"1..{STEPS_FAST - 1}, range {min(step_f[1:]) * 1e3:.2f}-{max(step_f[1:]) * 1e3:.2f} ms, "
        f"step 0 {step_f[0] * 1e3:.1f} ms, peak memory {peak_f / 2**30:.3f} GiB")
    log(f"fast | parity: median step {med_f * 1e3:.2f} | {parity['median_ms']:.2f} ms; profiled wall "
        f"{wall_f:.2f} | {parity['wall_ms']:.2f} ms; device busy {busy_f:.2f} | {parity['busy_ms']:.2f} ms; idle "
        f"share {1 - busy_f / wall_f:.3f} | {1 - parity['busy_ms'] / parity['wall_ms']:.3f}; launches a step "
        f"{n_launch_f} | {parity['launches']}; GEMM device time bf16 {bf16_f:.3f} | {parity['gemm_ms'][0]:.3f} ms, "
        f"other types {other_f:.3f} | {parity['gemm_ms'][1]:.3f} ms; peak memory {peak_f / 2**30:.3f} | "
        f"{parity['peak_gib']:.3f} GiB")
    log("GEMM kernels of one profiled step, fast preset:")
    for name, ms, count in gemms_f:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name}")
    log("GEMM kernels of one profiled step, parity preset:")
    for name, ms, count in gemms:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name}")
    assert bf16_f > 0, "no bf16 GEMM kernel ran in the fast preset's step"
    assert other_f > 0, "no f32 GEMM kernel remained in the fast preset's step"
    del renderer_f, stepper_f, ts_f

    # ---------------- 7. path P: pose-only steps with the mesh losses ----------------
    # person 1 steps in front of and into person 0, so the instance masks (made
    # with the bodies apart) disagree with the geometry and the bodies overlap
    transl_p = scene.transl.copy()
    transl_p[:, 1] = transl_p[:, 0] + np.array([0.1, 0.0, -0.15], np.float32)
    loss_p = LossConfig.from_config(conf.loss)._replace(sam_start_epoch=0)
    gen_p = torch.Generator(dev).manual_seed(SEED)
    renderer_p = MultiplyRenderer(conf, num_persons=P, num_frames=F_, generator=gen_p, device=dev)
    stepper_p = TrainStep(renderer_p, state, loss_p, learning_rate=conf.learning_rate,
                          interp_samples=INTERP_SAMPLES)
    ts_p = stepper_p.init_state(body_tables(scene, dev, transl_p))
    rng_p = np.random.default_rng(SEED)
    frames_p = [i % F_ for i in range(STEPS_POSE)]
    batches_p = [make_batch(scene, f, rng_p, dev, mode=MODE_POSE_ONLY) for f in frames_p]
    pose_batches = [pose_loss_batch(scene, f, rng_p, dev) for f in frames_p]
    before_p = {k: p.detach().clone() for k, p in ts_p.params().items()}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    ts_p, step_p, logs_p = run_steps("pose", stepper_p, ts_p, batches_p, gen_p, pose_batches)
    launches_p = read_counts()
    peak_p = torch.cuda.max_memory_allocated()
    # nn1: the render's 8, plus the deformer's forward warp of the padded meshes
    assert launches_p == {"nn1": 9 * STEPS_POSE, "grid_trilinear": STEPS_POSE}, f"pose step launches {launches_p}"
    pose_terms = {k: logs_p[k] for k in ("pose_depth_order_loss", "pose_silhouette_loss", "pose_interpenetration_loss")}
    assert pose_terms["pose_depth_order_loss"] > 0 or pose_terms["pose_interpenetration_loss"] > 0, pose_terms
    moved = {k for k, p in ts_p.params().items() if not torch.equal(p, before_p[k])}
    assert moved == {k for k in before_p if k.startswith("body.")}, f"pose-only step moved {sorted(moved)}"
    assert all(c == STEPS_POSE for c in ts_p.opt_pose.count.values()) and not any(ts_p.opt_joint.count.values())
    wall_p, busy_p, _, names_p, n_launch_p, _ = step_breakdown(
        lambda: stepper_p.step(ts_p, batches_p[0], generator=gen_p, pose_batch=pose_batches[0]))
    # the same step traced again with the card's activity alone: the two
    # traces must count the same launches, or one of them lost events
    _, busy_p2, _, _, n_launch_p2, _ = step_breakdown(
        lambda: stepper_p.step(ts_p, batches_p[0], generator=gen_p, pose_batch=pose_batches[0]), with_cpu=False)
    med_p = median(step_p[1:])
    log(f"train (pose-only, M={POSE_PIXELS} pixels, {MESH_BUCKET}-face meshes, {INTERP_SAMPLES} interpenetration "
        f"samples): median step {med_p * 1e3:.2f} ms over steps 1..{STEPS_POSE - 1}, range "
        f"{min(step_p[1:]) * 1e3:.2f}-{max(step_p[1:]) * 1e3:.2f} ms, step 0 {step_p[0] * 1e3:.1f} ms, peak memory "
        f"{peak_p / 2**30:.3f} GiB; profiled wall {wall_p:.2f} ms, device busy {busy_p:.2f} ms (idle share "
        f"{1 - busy_p / wall_p:.3f}), {n_launch_p} kernel launches of {names_p} kinds (traced again with the card's activity alone: "
        f"{n_launch_p2} launches, device busy {busy_p2:.2f} ms); last pose terms {pose_terms}; "
        f"moved: {sorted(moved)}")
    del renderer_p, stepper_p, ts_p, pose_batches

    # ---------------- 8. one step each of the other configurations ----------------
    for i, (name, updates, groups) in enumerate(VARIANTS):
        torch.cuda.empty_cache()
        run_variant(name, model_conf_with(conf, **updates), groups, scene, state, dev, SEED + 10 + i)

    # ---------------- 9. path T: the trainer ----------------
    torch.cuda.empty_cache()
    path_t = run_path_t()

    # ---------------- 10. path S: the SAM refinement path ----------------
    path_s = run_path_s()

    # ---------------- 11. --profile on path T's configuration ----------------
    t0 = time.perf_counter()
    prof = run_profile()
    log(f"--profile {prof['steps']} ({time.perf_counter() - t0:.1f} s with its set-up): {prof['wall_s']:.3f} s "
        f"traced; device time by category:")
    for r in prof["rows"]:
        log(f"  {r['category']:<24} {r['total_ms']:10.3f} ms  x{r['count']:<6d} {r['pct']:5.1f}%")

    launches_by_path = {"parity": launches, "fast": launches_f, "pose": launches_p,
                        "trainer": path_t["launches_a"], "trainer_pose": path_t["launches_b"],
                        "sam": path_s["launches"]}
    steps_by_path = {"parity": STEPS, "fast": STEPS_FAST, "pose": STEPS_POSE,
                     "trainer": path_t["steps_a"], "trainer_pose": path_t["steps_b"],
                     "sam": path_s["steps"]}
    # the trainer's counts hold its stages' launches too: per step only for the step paths
    per_step = {path: {k: n / steps_by_path[path] for k, n in launches_by_path[path].items()}
                for path in ("parity", "fast", "pose")}
    log(f"kernel launches by path: {launches_by_path} over steps {steps_by_path}")

    kernels = [
        {
            "name": "nn1", "route": "cuda", "source": "multiply_tpu_torch/csrc/nn1.cu",
            "replaces": "multiply_tpu/ops/knn_pallas.py:62 (nn1_pallas / _nn_kernel)",
            # `launches` and `launches_per_step` are the parity path's own pair
            "launches": launches["nn1"], "launches_per_step": per_step["parity"]["nn1"],
            "launches_by_path": {k: v["nn1"] for k, v in launches_by_path.items()}, "steps_by_path": steps_by_path,
            "launches_per_step_by_path": {k: v["nn1"] for k, v in per_step.items()},
            "max_abs_err": max(err_a, err_a3, err_a4, path_t["held_err"]["nn1"]),
            "max_err": max(err_a, err_a3, err_a4, path_t["held_err"]["nn1"]),
            "max_abs_err_path_t": path_t["held_err"]["nn1"],
            "shapes_held_path_t": sum(1 for k in path_t["held"] if k[0] == "nn1"),
            "max_abs_err_pose_meshes": err_a4, "ms_pose_meshes": t_a4, "ms": t_a, "kernel_ms": t_a,
            "plain_ms": t_a_plain, "bound_ms": bound_a,
            "bound_by": "operations" if a_ops / PEAK_FP32_FLOPS > a_bytes / PEAK_BYTES else "bytes",
            "library_ms": t_a_lib, "device_ms": dev_a, "host_us": host_a, "host_us_best": host_a_best,
            "shape": f"P={P} N={n_sampler} V={V}",
            "ms_v6890": t_a2, "device_ms_v6890": dev_a2, "bound_ms_v6890": bound_a2,
            "exact_build": {"ms": t_a_exact, "device_ms": dev_a_exact, "ms_v6890": t_a2_exact,
                            "device_ms_v6890": dev_a2_exact},
        },
        {
            "name": "grid_trilinear", "route": "cuda", "source": "multiply_tpu_torch/csrc/grid_trilinear.cu",
            "replaces": "multiply_tpu/ops/grid_pallas.py:80 (_grid_trilinear / _kernel)",
            "launches": launches["grid_trilinear"], "launches_per_step": per_step["parity"]["grid_trilinear"],
            "launches_by_path": {k: v["grid_trilinear"] for k, v in launches_by_path.items()},
            "steps_by_path": steps_by_path,
            "launches_per_step_by_path": {k: v["grid_trilinear"] for k, v in per_step.items()},
            "max_abs_err": max(err_b, err_b1, path_t["held_err"]["grid_trilinear"]),
            "max_err": max(err_b, err_b1, path_t["held_err"]["grid_trilinear"]),
            "max_abs_err_path_t": path_t["held_err"]["grid_trilinear"],
            "shapes_held_path_t": sum(1 for k in path_t["held"] if k[0] == "grid_trilinear"),
            "ms": t_b, "kernel_ms": t_b,
            "plain_ms": t_b_plain, "bound_ms": bound_b,
            "bound_by": "operations" if b_ops / PEAK_FP32_FLOPS > b_bytes / PEAK_BYTES else "bytes",
            "library_ms": t_b_lib, "device_ms": dev_b, "host_us": host_b, "host_us_best": host_b_best,
            "shape": f"P={P} N={n_render} res={res} group={S}",
            "ms_group1": t_b1, "device_ms_group1": dev_b1,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
