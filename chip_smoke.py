#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: needs CUDA (there is no CPU path); prints the card's name and
     power limit and turns TF32 off for matmuls and cuDNN;
  2. build: compiles both hand-written kernels from `multiply_tpu_torch/csrc`
     (one nvcc per source, in parallel) into `multiply_tpu_torch/_build`, plus
     the exactly rounded build of `nn1` that only the checks use, then the
     host C++ (the native mesh code and the JPEG decoder); prints
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
  7. path O, pose-only steps with a `PoseLossBatch` of the synthetic scene
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
 11. path P, the preprocessing chain (`run_path_p`): SMPL pickles at 6890
     vertices written by `body/synthetic_pickle.py`; a raw TRACE npz of 2
     persons x 2 frames (shuffled detections, 1-based track ids, keypoints
     the bodies' projected joints, poses and translations corrupted) and
     540x720 PNG frames, made with the port; `python -m
     multiply_tpu_torch.preprocessing` on the card at 150 refinement
     iterations (keypoint error must fall, masks non-empty, every file
     written); the training entry on `confs/taichi01_base.yaml` at full width
     on that directory and the pickles for 2 epochs (SMPL init cut to 50
     steps), `nn1` at V = 6890, each new kernel shape held to its plain
     version; the test entry on one frame; `export_visualization` of both
     frames (shading covers the projected bodies, a GIF89a with one image
     block a frame); both kernels timed at the trainer's shapes. Prints the
     seconds of PnP, refinement (per frame), finalize, set-up with the
     canonical `sdf_grid` bakes on their own, epochs and stages, the test
     entry, launches and peak memory;
 12. path V, the ViTPose model and JPEG frames (`run_path_v`): the committed
     JPEG fixtures (`tests/data/torch_jpeg`) decoded bit for bit as OpenCV
     decoded them and a 540x720 frame's decode time; ViTPose-H at its
     published widths (hidden 1280, 32 layers, 16 heads, 256x192 crops, the
     classic decoder, 17 keypoints) with random weights from SEED, written
     as a `from_pretrained` directory (`config.json`, `model.safetensors`)
     and loaded by `VitPoseDetector`: the card's heatmaps held to the same
     module's f32 forward on the CPU (VITPOSE_REL_TOL), the forward timed at
     2 and 8 crops beside its bound, its launches and peak memory; one
     forward of the simple decoder at ViTPose-B widths; then the
     preprocessing entry on path P's scene with its frames as JPEG (a
     scaffold baseline encoder, held to the source by PSNR) and `--vitpose`:
     every frame's boxes reach the detector, every keypoint handed to the
     refinement is finite and every file is written;
 13. `cli/train.py --profile 3` on path T's configuration and its table of
     device time by category;
 14. path D, several devices (`run_path_d`; two processes time-slicing the one
     card, so its times show the port's overhead, not a scaling figure): D1,
     the sharded step (`parallel.sharded_train_step`) on 2 gloo ranks both on
     cuda:0 at the parity preset's widths, 512 rays (256 a rank), 5 steps from
     the same parameters and whole-batch noise as a group-less run in this
     process: each loss and the parameters within D_RTOL, the ranks' parameters
     bitwise equal (all-gathered), no skipped update, both kernels held to
     their plain versions on rank 0 at the per-rank shapes and timed there;
     D2, a 1-rank NCCL group: bitwise the group-less run, NCCL's kernel in a
     profiled step; D3, the training entry's ranks (`cli/train.py`
     `train_on_ranks`, 2 gloo ranks on cuda:0) on path T's configuration for
     epochs 0-1: rank 0's files, finite losses, a checkpoint that restores;
     then the entry's refusal of `--devices 2` on one card. Prints each rank's
     median step beside the group-less one, the collectives a step with their
     bytes and CUDA-event times, each rank's peak memory and D3's epochs;
 15. path L, the example drivers (`run_path_l`, `multiply_tpu_torch/examples/`)
     at the invocations that README.md and the JAX package's runlogs record:
     L1 `train_synthetic --steps 50 --rays 256` (finite losses, no skipped
     update, the last 10 losses' mean below the first 10's, the PNG); L2
     `longrun_synthetic --epochs 180 --corrupt_masks --pose_noise 0.05
     --segmenter color` (its final opt_depth pass cut to L2_FINAL_PASS_ITERS
     iterations a frame), each segment printed beside RUNLOG_CORRUPT.md's row
     and held to it: the initial gt IoU and translation error, `certain` and
     `delayed` exactly, the pose depth-order loss's epochs, and bands on gt
     IoU, translation rmse and val PSNR (L_GT_IOU_MIN, L_RMSE_MAX_CM,
     L_PSNR_MIN), with each segment's seconds, stage seconds, peak memory and
     launches; L3 `optdepth_demo` on L2's run; L4 `mask_refinement_demo` at
     its defaults, 200 epochs (the corrupted frames flagged at epoch 20, the
     supervision IoU risen), in a spawned process of its own that begins
     beside L1 and shares the card with L1-L3 (`l4_in_child`: its own launch
     counters, zeroed before it and read after, and its own kernel holds); L5
     `scaling_curve --rays 256 --iters 5` at 1 NCCL rank and 2 gloo ranks on
     cuda:0. Both kernels held to their plain versions on each new shape
     (`grid_trilinear` at res 24) and timed at L2's training-step shapes.
     From L2's epoch-100 state (`examples/one_state.py`), a joint step, a
     pose-only step, the mesh refresh, the instance-mask and SAM stages and
     one opt_depth iteration run on the card and on the CPU with the same
     inputs and noise, held within f32 tolerances: a gap fails the script.
     The bands against the JAX package's recorded runs (L2's gt IoU,
     translation rmse and PSNR, L3's PSNR gap, L4's IoU rise) are printed
     with the ones missed and do not fail the run: the card and the CPU part
     by f32 rounding amplified by discrete choices (PERF.md section 6), and
     L2's share of segments that hold the gt-IoU band is printed beside the
     shares over keys 0-7 (L_KEY_SHARE); every other check of the path is
     fatal.
 16. path M, one person and three persons (`run_path_m1`, `run_path_m2`):
     M1, full-width steps of the parity preset at P = 3 (the pairwise and
     the sorted composite, then pose-only steps with a `PoseLossBatch` of
     three overlapping bodies) and at P = 1, each with its median step and
     range, launches, idle share and peak memory, and the renderer's
     composite alone (forward and backward) at P = 1, 2 and 3; M2, the
     training entry's code on `confs/synthetic_p3.yaml` at its 4 frames of
     48x64 and 60 epochs across every stage boundary (mesh refresh at 20 and
     40, pose correction until 24, opt_depth at 30 cut to 2 iterations a
     frame, instance masks + the entry's SAM stage and validation at 0 and
     50), then one frame of the test entry: every step's loss finite, no
     update skipped, its mode `_select_mode`'s, one `grid_trilinear` and the
     sampler's `nn1` launches in each step, the stages' files with P = 3 in
     their shapes and all three persons' meshes, each kernel held to its
     plain version on each new shape. Phase 4 holds and times both kernels
     at P = 1 and P = 3 too.
 17. path N (`run_path_n`): N1, the training entry's code on
     `synthetic_base.yaml` with `model.stage_overlap` to epoch 41, the mesh
     refreshes of 20 and 40 and the mask + SAM stage of epoch 0 on the stage
     worker: each harvested grid against the main thread's bake of the same
     snapshot, the step after a harvest reading the new grid, modes and
     losses, the files; the epochs that overlapped a bake printed beside
     those that did not. N2, `SamSegmenter` with `vit_h` at random weights on
     `synthetic_p3.yaml`'s frames (prompts past 64 points), its first frame
     held to the CPU's run of the same weights (SAM_F64_TOL of the largest
     logit). N3, a pose-only epoch at P = 3 with `depth_end` off: every body
     leaf moves and no net leaf, the sampler's rounds + 4 `nn1` launches a
     step. N4, a full-width delayed-pose step on edge-sampled rays
     (`edge_sampling_on`) of path P's directory. Phase 8 adds one step each
     of `smpl_surface_weight`, `zero_pose_weight` and the shadow channel.
Each of the paths 5-7, 9-12, 14 (D1, rank 0), 15 (L4 in its own process),
16 (each M1 run, and M2) and 17 zeroes the kernels' launch counters just before it
and reads them just after. Prints the `{"kernels": [...]}` line,
then the nvidia-smi line, then `{"ok": true, "device": {...}}` as the last
line.
"""

import copy
import json
import math
import os
import pickle
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
# path P: the preprocessing chain on the 6890-vertex pickle, then the entries on its directory
PREP_CONF = os.path.join("confs", "taichi01_base.yaml")
PREP_VERTS = 6890
PREP_FRAMES, PREP_PERSONS = 2, 2
PREP_HW = (540, 720)  # tracker frames; the training images are half that (--scale_factor 2)
PREP_FOCAL, PREP_CENTER = 720.0, (360.5, 270.5)
PREP_EPOCHS = 2
PREP_SMPL_INIT_STEPS = 50  # of the configured 2000
# path V: ViTPose at the reference's widths (ViTPose-H, classic decoder) and JPEG frames of path P's scene
VITPOSE_H = {"hidden_size": 1280, "num_hidden_layers": 32, "num_attention_heads": 16}
VITPOSE_B = {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12}
VITPOSE_CROPS = (2, 8)  # crops a frame: the timed forwards
VITPOSE_CHECK_CROPS = 2  # crops held to the CPU's f32 forward
VITPOSE_REL_TOL = 1e-4  # max |card - CPU| of the heatmaps over their max |CPU|, both f32 with TF32 off
JPEG_QUALITY = 95
JPEG_MIN_PSNR = 25.0  # dB of the scaffold encoder's frames; OpenCV's own encoder at 95, 4:2:0: 28.8 on such noise


def log(*args):
    print(*args, flush=True)


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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


def queued_ms(fn, launches=50):
    """Device time of one call of `fn`: CUDA events around `launches` calls
    queued back to back, divided by their count (the host's launch time hides
    behind the card's work once a call runs longer than it takes to enqueue)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def time_kernels(q, r, grid_args, group):
    """Both kernels timed on the inputs a path handed them (`nn1` on (q, r),
    `grid_trilinear` on `grid_args` with `group`): call, queued, device and
    host time, bound, plain version and library call. Returns two dicts."""
    import torch

    from multiply_tpu_torch.ops import grid_cuda, knn_cuda

    with torch.no_grad():
        def run_a():
            return knn_cuda.nn1(q, r)

        def run_b():
            return grid_cuda.grid_trilinear(*grid_args, group=group)

        n_q, V = q.shape[-2], r.shape[-2]
        a = {"ms": cuda_time_ms(run_a), "plain_ms": cuda_time_ms(lambda: knn_cuda.nn1_plain(q, r), reps=10),
             "library_ms": cuda_time_ms(lambda: torch.cdist(q, r, compute_mode="donot_use_mm_for_euclid_dist").min(-1),
                                        reps=10)}
        a["device_ms"], _ = device_time_ms(run_a, "nn1_kernel")
        a["queued_ms"] = queued_ms(run_a)
        a["host_us"], _ = host_time_us(run_a)
        batch = q.shape[0] if q.dim() == 3 else 1
        a_ops = NN1_OPS_PER_PAIR * batch * n_q * V
        a_bytes = batch * (n_q * 12 + V * 12 + n_q * 12)
        a["bound_ms"] = max(a_ops / PEAK_FP32_FLOPS, a_bytes / PEAK_BYTES) * 1e3
        a["bound_by"] = "operations" if a_ops / PEAK_FP32_FLOPS > a_bytes / PEAK_BYTES else "bytes"
        a["shape"] = f"query {tuple(q.shape)} V={V}"
        grid, pts = grid_args[0], grid_args[1]
        res = grid.shape[-1]
        b = {"ms": cuda_time_ms(run_b),
             "plain_ms": cuda_time_ms(lambda: grid_cuda.grid_trilinear_plain(*grid_args, group=group), reps=10)}
        b["device_ms"], _ = device_time_ms(run_b, "grid_trilinear_kernel")
        b["queued_ms"] = queued_ms(run_b)
        b["host_us"], _ = host_time_us(run_b)
        n_pts, n_out = pts.shape[:-1].numel(), pts.shape[:-1].numel() // group
        b_bytes = n_pts * 12 + grid.numel() * 4 + grid.shape[0] * 24 + n_out * 4
        b_ops = (GRID_OPS_PER_POINT + (1 if group > 1 else 0)) * n_pts
        b["bound_ms"] = max(b_ops / PEAK_FP32_FLOPS, b_bytes / PEAK_BYTES) * 1e3
        b["bound_by"] = "operations" if b_ops / PEAK_FP32_FLOPS > b_bytes / PEAK_BYTES else "bytes"
        Pb = grid.shape[0]
        unit = (pts - grid_args[2][:, None, :]) / grid_args[3][:, None, :] / (res - 1) * 2 - 1
        b["library_ms"] = cuda_time_ms(lambda: torch.nn.functional.grid_sample(
            grid[:, None], unit.flip(-1)[:, None, None], mode="bilinear", padding_mode="border", align_corners=True,
        ).reshape(Pb, -1, group).min(-1))
        b["shape"] = f"points {tuple(pts.shape)} res {res} group={group}"
    return a, b


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


VARIANTS = (  # name, config updates, the parameter groups each adds, loss weights, the loss terms each adds, epoch
    ("sort composite", dict(composite_matmul=False), (), {}, (), 0),
    ("shared net + offset head + beta encoder",
     dict(use_person_encoder=True, implicit_network__cond="smpl_id", implicit_network__offset_head=True,
          implicit_network__beta_encoding=True),
     ("net.person_latent", "net.offset_head.", "net.beta_encoder."), {}, (), 0),
    ("cond smpl_tri", dict(implicit_network__cond="smpl_tri"), ("net.triplane.",), {}, (), 0),
    ("multi_triplane", dict(implicit_network__cond="smpl_tri", implicit_network__multi_triplane=True),
     ("net.triplane.planes_", "net.triplane.dense."), {}, (), 0),
    ("smpl_surface_weight", dict(loss__smpl_surface_weight=0.5), (), dict(smpl_surface_weight=0.5),
     ("smpl_surface_loss",), 0),
    # the pose conditioning is zeroed in training before epoch 20 and on every 20th: the term reads 0 there
    ("zero_pose_weight", dict(loss__zero_pose_weight=0.3), (), dict(zero_pose_weight=0.3), ("zero_pose_loss",), 30),
    ("shadow channel", dict(bg_rendering_network__d_out=4), ("net.bg_render.",), {}, (), 0),
)


def run_variant(name, conf, groups, scene, state, dev, seed, rays=RAYS, loss_kw=None, terms=(), epoch=0):
    """Two full-width steps of one model configuration. The first is timed
    (the first step of its shapes: printed, not compared). The second step's
    gradients are read: conditioning that enters through layer 0 is silent at
    the geometric init (its columns start at zero), so a new group's gradient
    can be exactly zero on the first step. `loss_kw` weights the terms that
    the configuration switches on; each of `terms` must be logged above 0;
    both steps run at `epoch`."""
    import numpy as np
    import torch

    from multiply_tpu_torch.engine.train import TrainStep
    from multiply_tpu_torch.models.loss import LossConfig
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    gen = torch.Generator(dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n_frames, n_persons = scene.poses.shape[:2]
    renderer = MultiplyRenderer(conf, num_persons=n_persons, num_frames=n_frames, generator=gen, device=dev)
    stepper = TrainStep(renderer, state, LossConfig(sam_start_epoch=0, **(loss_kw or {})),
                        learning_rate=conf.learning_rate)
    ts = stepper.init_state(body_tables(scene, dev))
    ts.epoch = epoch
    torch.cuda.reset_peak_memory_stats()
    ts, step_s, _ = run_steps(name, stepper, ts, [make_batch(scene, 0, rng, dev, rays)], gen)
    loss, logs, grads = stepper.loss_and_grads(ts, make_batch(scene, 1, rng, dev, rays), generator=gen)
    torch.cuda.synchronize()
    assert math.isfinite(float(loss.detach())), f"{name}: non-finite loss"
    for term in terms:
        assert float(logs[term].detach()) > 0, f"{name}: {term} {float(logs[term].detach())}"
    for group in groups:
        leaves = {k: g for k, g in grads.items() if k.startswith(group)}
        assert leaves, f"{name}: no parameter named {group}*"
        assert all(bool(torch.isfinite(g).all()) for g in leaves.values()), f"{name}: non-finite gradient in {group}*"
        assert all(float(g.abs().max()) > 0 for g in leaves.values()), f"{name}: zero gradient in {group}*"
    n_params = sum(p.numel() for p in renderer.parameters())
    log(f"variant {name}: step {step_s[0] * 1e3:.1f} ms (first step of its shapes), {n_params / 1e6:.2f} M net "
        f"parameters, peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, second loss "
        f"{float(loss.detach()):.5f}{''.join(f', {t} {float(logs[t].detach()):.5f}' for t in terms)}, gradients finite "
        f"and non-zero on {list(groups) or 'no new group'}")


def zero_counts():
    from multiply_tpu_torch.ops import grid_cuda, knn_cuda

    knn_cuda.nn1.launches = 0
    grid_cuda.grid_trilinear.launches = 0


def read_counts():
    from multiply_tpu_torch.ops import grid_cuda, knn_cuda

    return {"nn1": knn_cuda.nn1.launches, "grid_trilinear": grid_cuda.grid_trilinear.launches}


def hold_kernels_on_path(path="T", inputs=None):
    """While a path (T or P) runs, hold each kernel to its plain version on the
    inputs that the path itself hands it: the first call of each new shape
    (`nn1`: query shape and V; `grid_trilinear`: point shape, grid resolution,
    group) has its output compared, on the same tensors, with the plain
    version's. No kernel is launched for the check, so the launch counts stay
    the path's own. A failure is recorded, not raised: the trainer's stages
    catch and print what they raise. With a dict `inputs`, a copy of each
    first call's arguments is kept there by shape, for timing after the run.
    Returns ({shape: max abs error}, failures, undo)."""
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

    def keep(key, *args):
        if inputs is not None and key not in inputs:
            with lock:
                inputs[key] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def nn1_held(query, refs):
        d2, idx = nn1(query, refs)
        key = ("nn1", tuple(query.shape), refs.shape[-2])
        name = f"path {path} nn1 query {tuple(query.shape)} V={refs.shape[-2]}"
        hold(key, lambda: compare_nn1(query, refs, d2, idx, name)[0])
        keep(key, query, refs)
        return d2, idx

    def grid_held(grid, points, origin, spacing, group=1):
        out = grid_trilinear(grid, points, origin, spacing, group=group)

        def compare():
            err = (out - grid_cuda.grid_trilinear_plain(grid, points, origin, spacing, group=group)).abs().max().item()
            assert err <= 1e-5, f"max abs error {err} > 1e-5"
            return err

        key = ("grid_trilinear", tuple(points.shape), grid.shape[-1], group)
        hold(key, compare)
        keep(key, grid, points, origin, spacing, group)
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


# ---- path D: several devices (rays split over ranks), 2 ranks time-slicing the one card ----
D_STEPS = 5  # one first step, four timed
D_RTOL = 1e-5  # each step's loss, the first step's gradients and the resolved parameters, against the group-less run
D_RESOLVED = 1e-3  # an entry whose gradients agree this closely (relative) in every step is held to D_RTOL
D_SEED = SEED + 50
D_TIMEOUT_S = 300.0  # the longest a rank waits in one collective (D3's rank 1 waits out rank 0's stages)


def d_program(dev):
    """The parity preset's program of phases 3-5 (taichi01 widths, the
    synthetic 2-person scene, grids at res 64, weights from SEED), built alike
    on every rank: (scene, stepper, ts)."""
    import torch

    from multiply_tpu_torch.config import load_config
    from multiply_tpu_torch.data.synthetic import make_scene
    from multiply_tpu_torch.engine.train import TrainStep
    from multiply_tpu_torch.models.loss import LossConfig
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    conf = load_config(os.path.join(ROOT, "confs", "model", "taichi01_model.yaml"))
    scene = make_scene(num_frames=4, num_persons=2, height=32, width=40, seed=SEED, device=dev)
    renderer = MultiplyRenderer(conf, num_persons=2, num_frames=4, generator=torch.Generator(dev).manual_seed(SEED),
                                device=dev)
    state = renderer.build_person_state(scene.servers, grid_res=64)
    stepper = TrainStep(renderer, state, LossConfig(sam_start_epoch=0), learning_rate=conf.learning_rate)
    return scene, stepper, stepper.init_state(body_tables(scene, dev))


def d_inputs(scene, stepper, dev):
    """D_STEPS whole batches of RAYS rays over the 4 frames, each with its
    whole-batch noise: [(batch, noise)]."""
    import numpy as np
    import torch

    rng, gen = np.random.default_rng(D_SEED), torch.Generator(dev).manual_seed(D_SEED)
    batches = [make_batch(scene, i % 4, rng, dev) for i in range(D_STEPS)]
    return [(b, stepper.draw_noise(b, None, gen)) for b in batches]


def flat_params(ts):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in ts.params().values()])


def record_grads(stepper):
    """Each step's gradients as one flat vector (parameter order), taken where
    the step hands them to its update; returns the list it fills."""
    import torch

    seen, update = [], stepper.update

    def recorded(ts, mode, loss, logs, grads):
        seen.append(torch.cat([g.reshape(-1) for g in grads.values()]).clone())
        return update(ts, mode, loss, logs, grads)

    stepper.update = recorded
    return seen


def shares_in_one_process(stepper, ts, batch, noise, world=2):
    """The gradient that `world` ranks sum, computed share by share in this
    process (flat, parameter order): every share's counts from a forward
    first, then each share's loss over the whole batch's counts and its
    gradient, added in rank order. It isolates the ranks' arithmetic from the
    processes and collectives."""
    import torch

    from multiply_tpu_torch.models.loss import RayShare
    from multiply_tpu_torch.parallel import shard_batch, shard_noise

    shares = [(shard_batch(batch, r, world), shard_noise(noise, r, world)) for r in range(world)]
    counts = []
    with torch.no_grad():
        for b, n in shares:
            stepper.forward_loss(ts, b, n, share=RayShare(world, lambda t: counts.append(t.clone()) or t))
    total = torch.stack(counts).sum(0)
    flat = None
    for b, n in shares:
        _, _, grads = stepper.loss_and_grads(ts, b, n, share=RayShare(world, lambda t: t.copy_(total)))
        g = torch.cat([v.reshape(-1) for v in grads.values()])
        flat = g if flat is None else flat + g
    return flat


def leaf_gap(a, b, sizes):
    """The largest |a - b| of a leaf over that leaf's largest |b|, worst leaf."""
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a.split(sizes), b.split(sizes)))


def time_collectives(group):
    """Record each tensor collective of `group` as (name, bytes, ms by CUDA
    events around it); returns the list it fills."""
    import torch

    done, run = [], group._run

    def timed(op, t, *args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = run(op, t, *args)
        b.record()
        b.synchronize()
        done.append((op.__name__, t.numel() * t.element_size(), a.elapsed_time(b)))
        return out

    group._run = timed
    return done


def d_rank(group, profile=False):
    """One rank of path D1 (2 gloo ranks on cuda:0) or D2 (1 NCCL rank): the
    program built from the seeds, rank 0's state and D_STEPS inputs sent to
    the others (`replicate`, `broadcast_tree`), then D_STEPS sharded steps.
    Rank 0 returns its losses, parameters and collectives, every rank's median
    step time and peak memory, whether the ranks' parameters are bitwise
    equal, and with `profile` the backend and the NCCL operations (host) and
    kernels (card) of one more profiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from multiply_tpu_torch.parallel import replicate, sharded_train_step
    from multiply_tpu_torch.parallel.sharding import broadcast_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = str(group.device)
    scene, stepper, ts = d_program(dev)
    inputs = broadcast_tree(d_inputs(scene, stepper, dev) if group.rank == 0 else None, group)
    replicate([ts.params(), ts.opt_joint, ts.opt_pose, stepper.state], group)
    out = {"init": flat_params(ts).clone(), "losses": [], "skipped": [], "step_ms": [], "grads": record_grads(stepper)}
    step = sharded_train_step(stepper, group)
    collectives = time_collectives(group)
    torch.cuda.reset_peak_memory_stats()
    for batch, noise in inputs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, logs = step(ts, batch, noise=noise)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(logs["loss"]))
        out["skipped"].append(float(logs["update_skipped"]))
    out["collectives"] = list(collectives)
    del group._run  # the class's own again
    out["final"] = flat_params(ts)
    every = group.all_gather(out["final"][None])
    out["ranks_equal"] = all(torch.equal(every[0], every[r]) for r in range(group.world))
    mine = torch.tensor([[median(out["step_ms"][1:]), torch.cuda.max_memory_allocated() / 2**30]], device=dev)
    out["per_rank"] = group.all_gather(mine).tolist()
    out["grad_bytes"] = out["final"].numel() * out["final"].element_size()
    if profile:
        batch, noise = inputs[-1]
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(ts, batch, noise=noise)
            torch.cuda.synchronize()
        events = prof.key_averages()
        nccl = [e for e in events if "nccl" in e.key.lower()]
        out["nccl_kernels"] = sorted({e.key for e in nccl if e.device_type == DeviceType.CUDA})
        out["nccl_ops"] = sorted({e.key for e in nccl if e.device_type == DeviceType.CPU})
        out["backend"] = torch.distributed.get_backend()
    return out


def run_path_d():
    """Path D: the sharded step and the training entry over ranks, on the one
    card. D1: 2 gloo ranks on cuda:0 against the group-less step in this run,
    both kernels held on rank 0 at the per-rank shapes; D2: a 1-rank NCCL
    group, bitwise the group-less step; D3: `cli/train.py`'s ranks (2 on
    cuda:0) on path T's configuration for epochs 0-1, then the real entry's
    refusal of `--devices 2` on one card. Two processes time-slice one card:
    the times show the port's overhead, not a scaling result."""
    import torch

    from multiply_tpu_torch.cli import train as cli_train
    from multiply_tpu_torch.parallel import launch

    out_dir = os.path.join(ROOT, "outputs", "chip_smoke_path_d")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t_path = time.perf_counter()

    # ---- the group-less run, and its first gradient again and as two shares in this process ----
    scene, stepper, ts = d_program("cuda")
    init = flat_params(ts).clone()
    inputs = d_inputs(scene, stepper, "cuda")
    again = torch.cat([g.reshape(-1) for g in stepper.loss_and_grads(ts, *inputs[0])[2].values()])
    halves = shares_in_one_process(stepper, ts, *inputs[0])
    ref = {"losses": [], "step_ms": [], "grads": record_grads(stepper)}
    lr = stepper.lr
    for batch, noise in inputs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, logs = stepper.step(ts, batch, noise=noise)
        torch.cuda.synchronize()
        ref["step_ms"].append((time.perf_counter() - t0) * 1e3)
        ref["losses"].append(float(logs["loss"]))
    names = {k: p.numel() for k, p in ts.params().items()}
    final = flat_params(ts)
    del scene, stepper, ts, inputs
    torch.cuda.empty_cache()

    # ---- D1: 2 gloo ranks on cuda:0 ----
    kernel_inputs = {}
    held, failures, unhold = hold_kernels_on_path("D", kernel_inputs)
    zero_counts()
    t0 = time.perf_counter()
    try:
        d1 = launch(d_rank, (), ["cuda:0", "cuda:0"], "gloo", os.path.join(out_dir, "rendezvous_d1"), D_TIMEOUT_S)
    finally:
        unhold()
    d1_s = time.perf_counter() - t0
    launches = read_counts()
    problems = []  # path D's failed checks, raised after D3 so that one run shows every phase
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(d1["losses"], ref["losses"]))
    # the first step starts from the same parameters. Against the same two shares computed in this process it
    # shows the ranks' own arithmetic; against the whole batch, the card's rounding at other shapes, which the
    # sampler's discrete choices amplify (the CPU tests hold the 2-rank step to the 1-process step to 1e-6)
    sizes = list(names.values())
    g_rank = leaf_gap(d1["grads"][0], halves, sizes)
    g_whole = leaf_gap(d1["grads"][0], ref["grads"][0], sizes)
    g_halves, g_again = leaf_gap(halves, ref["grads"][0], sizes), leaf_gap(again, ref["grads"][0], sizes)
    # Adam normalises each entry's step, so an entry whose gradient is no larger than the rounding moves by up to
    # 2 lr a step either way: entries whose gradients agree within D_RESOLVED in every step are held to D_RTOL
    resolved = torch.stack([(a - b).abs() <= D_RESOLVED * b.abs()
                            for a, b in zip(d1["grads"], ref["grads"])]).all(0)
    gap = (d1["final"] - final).abs()
    top = float(final.abs().max())
    gap_res, gap_rest = float(gap[resolved].max()), float(torch.where(resolved, 0.0, gap).max())
    n_rest = int((~resolved).sum())
    per_step = [c for c in d1["collectives"] if c[0] == "all_reduce"]
    grads = [c for c in per_step if c[1] == d1["grad_bytes"]]
    small = [c for c in per_step if c[1] != d1["grad_bytes"]]
    log(f"path D1 (2 gloo ranks on cuda:0, {RAYS} rays a step, {RAYS // 2} a rank; {smi_line()}): losses "
        f"{[round(x, 6) for x in d1['losses']]} against {[round(x, 6) for x in ref['losses']]} (worst relative "
        f"{loss_gap:.3g}); first step's gradients, worst leaf's gap over its largest: rank 0 against the two shares "
        f"in one process {g_rank:.3g}, against the whole batch {g_whole:.3g} (the two shares in one process against "
        f"the whole batch {g_halves:.3g}; the whole batch against itself again {g_again:.3g}); parameters after "
        f"{D_STEPS} steps: max |gap| {gap_res:.3g} of largest {top:.4g} on the {resolved.numel() - n_rest} entries "
        f"whose gradients agree within {D_RESOLVED} in every step, {gap_rest:.3g} (lr {lr}) on the other {n_rest}; "
        f"ranks bitwise equal: {d1['ranks_equal']}; skipped {d1['skipped']}; rank 0 launches {launches}")
    log(f"path D1 times (two processes time-slice one card: the port's overhead, not a scaling figure): median step "
        f"ms by rank {[round(r[0], 2) for r in d1['per_rank']]} against {median(ref['step_ms'][1:]):.2f} group-less; "
        f"peak memory GiB by rank {[round(r[1], 3) for r in d1['per_rank']]}; {len(per_step) / D_STEPS:g} all-reduces "
        f"a step: the gradient buffer {d1['grad_bytes']} bytes ({sum(sizes)} parameters) in "
        f"{median([c[2] for c in grads]):.3f} ms median, the counts and the logged terms "
        f"{sorted({c[1] for c in small})} bytes in {median([c[2] for c in small]):.3f} ms median (CUDA events, gloo "
        f"through the host); D1 {d1_s:.1f} s with rank 1's start")
    checks = [
        (not failures, f"path D kernel holds: {failures}"),
        (torch.equal(d1["init"], init), "rank 0 did not start from the group-less run's parameters"),
        (loss_gap <= D_RTOL, f"D1 losses {d1['losses']} against {ref['losses']}"),
        (g_rank <= D_RTOL, f"D1's first gradient parts from the same shares in one process by {g_rank:.3g}"),
        (g_whole <= 1e-2, f"D1's first gradient parts from the whole batch's by {g_whole:.3g}"),
        (gap_res <= D_RTOL * top, f"D1 parameters part by {gap_res} where resolved (largest {top})"),
        (gap_rest <= 2 * lr * D_STEPS, f"D1 parameters part by {gap_rest} where unresolved"),
        (d1["ranks_equal"], "D1: the ranks' parameters differ"),
        (not any(d1["skipped"]), f"D1 skipped an update: {d1['skipped']}"),
        (launches == {"nn1": 8 * D_STEPS, "grid_trilinear": D_STEPS}, f"D1 rank 0 launches {launches}"),
    ]
    problems += [msg for ok, msg in checks if not ok]

    # the kernels at the per-rank shapes that rank 0 handed them
    n_rank = RAYS // 2 * 128  # a sampler round: rays x N_samples_eval points a person
    key_a = next(k for k in kernel_inputs if k[0] == "nn1" and k[1][-2] == n_rank)
    key_b = next(k for k in kernel_inputs if k[0] == "grid_trilinear")
    a, b = time_kernels(*kernel_inputs[key_a], kernel_inputs[key_b][:4], kernel_inputs[key_b][4])
    held_err = {k: max((e for key, e in held.items() if key[0] == k), default=None)
                for k in ("nn1", "grid_trilinear")}
    log(f"path D kernels at rank 0's shapes: nn1 {a['shape']}: call {a['ms']:.4f} ms, queued {a['queued_ms']:.4f} ms, "
        f"bound {a['bound_ms']:.5f} ms ({a['bound_by']}), plain {a['plain_ms']:.4f} ms, cdist+min "
        f"{a['library_ms']:.4f} ms; grid_trilinear {b['shape']}: call {b['ms']:.4f} ms, queued "
        f"{b['queued_ms']:.4f} ms, "
        f"bound {b['bound_ms']:.6f} ms ({b['bound_by']}), plain {b['plain_ms']:.4f} ms, grid_sample+min "
        f"{b['library_ms']:.4f} ms; held by shape "
        f"{({' '.join(map(str, k)): float(f'{e:.3g}') for k, e in held.items()})}")
    del kernel_inputs
    torch.cuda.empty_cache()

    # ---- D2: a 1-rank NCCL group ----
    d2 = launch(d_rank, (True,), ["cuda:0"], "nccl", os.path.join(out_dir, "rendezvous_d2"), D_TIMEOUT_S)
    d2_gap = float((d2["final"] - final).abs().max())
    problems += [msg for ok, msg in [
        (d2["losses"] == ref["losses"], f"D2 losses {d2['losses']} against {ref['losses']}"),
        (d2_gap == 0.0, f"D2: parameters part from the group-less run's by {d2_gap}"),
        (d2["backend"] == "nccl" and any("reduce" in k.lower() for k in d2["nccl_ops"]),
         f"D2: no NCCL all-reduce in the profiled step ({d2['backend']}: {d2['nccl_ops']})"),
    ] if not ok]
    # NCCL launches no kernel for an in-place all-reduce over one rank: the host's NCCL operation shows the path
    log(f"path D2 (1 NCCL rank): losses {d2['losses']}, parameters' max gap {d2_gap} to the group-less run's; NCCL "
        f"operations (host) {d2['nccl_ops']}, NCCL kernels (card) {d2['nccl_kernels']}; median step "
        f"{d2['per_rank'][0][0]:.2f} ms; all-reduce of the gradient buffer "
        f"{median([c[2] for c in d2['collectives'] if c[1] == d2['grad_bytes']]):.3f} ms median ({smi_line()})")

    # ---- D3: the training entry's ranks on path T's configuration ----
    run_dir = os.path.join(out_dir, "train")
    args = cli_train.parse_args(["--conf", os.path.join(ROOT, TRAIN_CONF), "--run_dir", run_dir, "--device", "cuda",
                                 "--max_epochs", "2", *(f"--set={s}" for s in RUN_A_SETS),
                                 f"--set=dist_timeout_s={D_TIMEOUT_S}"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli_train.train_on_ranks(args, ["cuda:0", "cuda:0"], "gloo")
    d3_s = time.perf_counter() - t0
    peak0 = torch.cuda.max_memory_allocated() / 2**30
    records = read_metrics(run_dir)
    epochs = [r for r in records if "epoch_seconds" in r]
    assert [r["epoch"] for r in epochs] == [0, 1], f"D3 epochs {[r['epoch'] for r in epochs]}"
    assert all(math.isfinite(r[k]) for r in epochs for k in r if k.endswith("_loss") or k == "loss"), epochs
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["epoch_00000", "last"]
    assert os.path.exists(os.path.join(run_dir, "val", "epoch_00000.png"))
    assert not os.path.exists(os.path.join(run_dir, cli_train.RENDEZVOUS_FILE))
    fresh, _, _ = cli_train.build_trainer(cli_train.parse_args(
        ["--conf", os.path.join(ROOT, TRAIN_CONF), "--run_dir", run_dir, "--device", "cuda",
         *(f"--set={s}" for s in RUN_A_SETS)]))
    fresh.load_checkpoint(os.path.join(run_dir, "checkpoints", "last"))
    assert fresh.epoch == 2 and all(torch.equal(p, trainer.ts.params()[k]) for k, p in fresh.ts.params().items())
    stages = {k: r[k] for r in records for k in r if k.endswith("_seconds") and k != "epoch_seconds"}
    log(f"path D3 (the entry's ranks, 2 on cuda:0, path T's configuration, epochs 0-1; {smi_line()}): epoch seconds "
        f"{[round(r['epoch_seconds'], 3) for r in epochs]}, stages on rank 0 {stages}, losses "
        f"{[round(r['loss'], 5) for r in epochs]}, rank 0's peak memory {peak0:.3f} GiB; checkpoint restored; "
        f"whole D3 {d3_s:.1f} s")
    del trainer, fresh
    torch.cuda.empty_cache()

    try:
        cli_train.main(["--conf", os.path.join(ROOT, TRAIN_CONF), "--run_dir", os.path.join(out_dir, "refused"),
                        "--devices", "2"])
        raise AssertionError("--devices 2 on one card was not refused")
    except SystemExit as e:
        refusal = str(e)
    assert f"2 CUDA devices asked for, {torch.cuda.device_count()} visible" in refusal, refusal
    assert not problems, f"path D: {problems}"
    out = {"d1": d1, "d2": d2, "ref": ref, "launches": launches, "nn1": a, "grid": b, "held": held,
           "held_err": held_err, "d3_s": d3_s, "epochs": epochs, "refusal": refusal,
           "seconds": time.perf_counter() - t_path}
    log(f"path D: the entry refuses --devices 2 here: {refusal!r}; whole path {out['seconds']:.1f} s")
    for d in (d1, d2):
        del d["init"], d["final"], d["grads"]
    return out


def write_tracker_output(root, smpl_dir):
    """Scaffolding for path P: what TRACE and a keypoint detector would hand
    the preprocessing, made with the port and numpy from the 6890-vertex body
    the pickles hold. PREP_PERSONS bodies with random shapes and near-canonical
    poses stand 4 m away; the keypoints are their projected COCO-17 joints; the
    tracker's poses and translations are those, corrupted; the raw TRACE npz
    holds one shuffled detection per person and frame with 1-based track ids
    and frame ids from 5; the PNG frames show each body in a flat tint over a
    noisy background. Returns (npz path, frames dir, true keypoints (F, P, 17, 3))."""
    import numpy as np
    import torch

    from multiply_tpu_torch.body.server import SMPLServer, canonical_pose_params, smpl_server_forward, stack_servers
    from multiply_tpu_torch.body.smpl import load_smpl_model
    from multiply_tpu_torch.engine.instance_masks import project_depth
    from multiply_tpu_torch.native import rasterize_depth
    from multiply_tpu_torch.preprocessing.refine import SMPL_TO_COCO17, project
    from multiply_tpu_torch.preprocessing.trace import TRACE_TO_COCO17
    from multiply_tpu_torch.utils.io import write_png

    rng = np.random.default_rng(SEED)
    F, P, (H, W) = PREP_FRAMES, PREP_PERSONS, PREP_HW
    K = np.array([[PREP_FOCAL, 0, PREP_CENTER[0]], [0, PREP_FOCAL, PREP_CENTER[1]], [0, 0, 1]], np.float32)
    model = load_smpl_model(smpl_dir, device="cpu")
    betas = (rng.standard_normal((P, 10)) * 0.2).astype(np.float32)
    server = stack_servers([SMPLServer.create(model, betas=b) for b in betas])
    poses = (canonical_pose_params(device="cpu").numpy() + rng.normal(0, 0.05, (F, P, 72))).astype(np.float32)
    trans = np.zeros((F, P, 3), np.float32)
    trans[..., 0] = np.arange(P) - (P - 1) / 2
    trans[..., 2] = 4.0
    kps = np.zeros((F, P, 17, 3), np.float32)
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    tints = np.array([[230, 110, 90], [90, 130, 230], [100, 210, 100], [210, 200, 80]], np.float32)
    for f in range(F):
        with torch.no_grad():
            out = smpl_server_forward(server, torch.ones(P), torch.as_tensor(trans[f]), torch.as_tensor(poses[f]),
                                      torch.as_tensor(betas))
            kps[f, :, :, :2] = project(out["smpl_all_jnts"][:, SMPL_TO_COCO17], torch.as_tensor(K), torch.eye(3),
                                       torch.zeros(3)).numpy()
        kps[f, :, :, 2] = 1.0
        img = (100 + 40 * rng.random((H, W, 3))).astype(np.float32)
        depth = np.full((H, W), np.inf, np.float32)
        P_mat = np.eye(4, dtype=np.float32)
        P_mat[:3, :3] = K
        for p in range(P):
            d = rasterize_depth(project_depth(P_mat, out["smpl_verts"][p].numpy()).astype(np.float32),
                                model.faces.numpy(), W, H)
            near = d < depth
            img[near], depth[near] = tints[p % len(tints)], d[near]
        write_png(os.path.join(frames_dir, f"{f:04d}.png"), img.astype(np.uint8))

    poses_init = poses + rng.normal(0, 0.05, poses.shape).astype(np.float32)
    trans_init = trans + rng.normal(0, 0.1, trans.shape).astype(np.float32)
    det = {k: [] for k in ("reorganize_idx", "track_ids", "smpl_thetas", "smpl_betas", "cam_trans", "j3d", "pj2d_org")}
    for f in range(F):
        for p in rng.permutation(P):
            pj = np.zeros((44, 2), np.float32)
            pj[TRACE_TO_COCO17] = kps[f, p, :, :2]
            for k, v in (("reorganize_idx", 5 + f), ("track_ids", int(p) + 1), ("smpl_thetas", poses_init[f, p]),
                         ("smpl_betas", betas[p]), ("cam_trans", trans_init[f, p]),
                         ("j3d", np.zeros((44, 3), np.float32)), ("pj2d_org", pj)):
                det[k].append(v)
    npz = os.path.join(root, "trace.npz")
    np.savez(npz, outputs={k: np.asarray(v) if k in ("reorganize_idx", "track_ids") else np.stack(v)
                           for k, v in det.items()})
    return npz, frames_dir, kps


def gif_image_blocks(path):
    """The image descriptors of a GIF89a file, counted by walking its blocks."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:6] == b"GIF89a", data[:6]
    flags = data[10]
    pos = 13 + (3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0)
    images = 0

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # extension: label, then sub-blocks
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:  # image: descriptor, [local table], LZW size, sub-blocks
            images += 1
            local = data[pos + 9]
            pos += 10 + (3 * 2 ** ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)
        else:
            raise AssertionError(f"GIF: unknown block 0x{data[pos]:02x} at {pos}")
    return images


def run_path_p():
    """Path P: the preprocessing chain on the card, then training and testing
    on the directory it wrote, with the 6890-vertex body. (1) SMPL pickles at
    6890 vertices (`write_synthetic_smpl_dir`); (2) tracker output and 540x720
    frames (`write_tracker_output`); (3) the preprocessing entry at its default
    150 refinement iterations and scale factor 2: the refined keypoint error
    below the initial one, every mask non-empty, every file written; (4) the
    training entry on `confs/taichi01_base.yaml` at full width on that
    directory and the pickles for PREP_EPOCHS epochs (epoch 0 with its
    instance masks, SAM stage, validation and checkpoint), every step finite
    in the mode `_select_mode` gives, `nn1` run at V = 6890, each new shape of
    either kernel held to its plain version; (5) the test entry on one frame
    and `export_visualization` of both frames' posed SMPL meshes; (6) both
    kernels timed at the shapes the trainer handed them. Returns a dict of
    what it measured."""
    import numpy as np
    import torch

    import multiply_tpu_torch.engine.trainer as trainer_module
    import multiply_tpu_torch.models.renderer as renderer_module
    from multiply_tpu_torch.body.server import smpl_server_forward
    from multiply_tpu_torch.body.synthetic_pickle import write_synthetic_smpl_dir
    from multiply_tpu_torch.cli import test as cli_test
    from multiply_tpu_torch.cli import train as cli_train
    from multiply_tpu_torch.engine.instance_masks import project_depth
    from multiply_tpu_torch.engine.visualize import export_visualization
    from multiply_tpu_torch.native import rasterize_depth
    from multiply_tpu_torch.preprocessing import pipeline, refine
    from multiply_tpu_torch.preprocessing.__main__ import main as preprocess_main
    from multiply_tpu_torch.utils.io import read_png

    dev = "cuda"
    root = os.path.join(ROOT, "outputs", "chip_smoke_path_p")
    shutil.rmtree(root, ignore_errors=True)
    smpl_dir, data_dir, run_dir = (os.path.join(root, d) for d in ("smpl_model", "data", "run"))
    out = {}
    zero_counts()
    t_path = time.perf_counter()

    # ---- (1) body, (2) tracker output ----
    t0 = time.perf_counter()
    write_synthetic_smpl_dir(smpl_dir, num_verts=PREP_VERTS, seed=SEED)
    npz, frames_dir, kps_true = write_tracker_output(root, smpl_dir)
    out["scaffold_s"] = time.perf_counter() - t0

    # ---- (3) preprocessing ----
    frame_s, refined = [], {}
    refine_frame, refine_sequence = refine.refine_frame, pipeline.refine_sequence

    def timed_frame(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = refine_frame(*args, **kw)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        return result

    def kept_sequence(server, K, R, t, poses, transl, betas, keypoints_2d, cfg):
        result = refine_sequence(server, K, R, t, poses, transl, betas, keypoints_2d, cfg)
        refined.update(server=server, K=K, before=(poses, transl, betas), after=result, kp=keypoints_2d, cfg=cfg)
        return result

    refine.refine_frame, pipeline.refine_sequence = timed_frame, kept_sequence
    try:
        seconds = preprocess_main(["--trace", npz, "--frames", frames_dir, "--out", data_dir, "--smpl_model",
                                   os.path.join(smpl_dir, "SMPL_NEUTRAL.pkl"), "--focal", str(PREP_FOCAL),
                                   "--center", *map(str, PREP_CENTER), "--device", dev])
    finally:
        refine.refine_frame, pipeline.refine_sequence = refine_frame, refine_sequence
    cfg = refined["cfg"]
    assert cfg.iters == 150 and cfg.is_vitpose and len(frame_s) == PREP_FRAMES, (cfg, frame_s)
    assert refined["server"].verts_c.shape[-2] == PREP_VERTS, tuple(refined["server"].verts_c.shape)

    def keypoint_error(poses, transl, betas):
        errs = []
        with torch.no_grad():
            for f in range(PREP_FRAMES):
                o = smpl_server_forward(refined["server"], torch.ones(PREP_PERSONS, device=dev), transl[f], poses[f],
                                        betas)
                pix = refine.project(o["smpl_all_jnts"][:, refine.SMPL_TO_COCO17], refined["K"],
                                     torch.eye(3, device=dev), torch.zeros(3, device=dev))
                errs.append((pix - refined["kp"][f, ..., :2]).norm(dim=-1).mean().item())
        return sum(errs) / len(errs)

    err0, err1 = keypoint_error(*refined["before"]), keypoint_error(*refined["after"])
    assert err1 < err0, f"refinement raised the keypoint error {err0} -> {err1}"
    n_frames = PREP_FRAMES
    missing = [f for f in (*pipeline.FILES, *(f"image/{i:04d}.png" for i in range(n_frames)),
                           *(f"mask/{p}/{i:04d}.png" for p in range(PREP_PERSONS) for i in range(n_frames)))
               if not os.path.exists(os.path.join(data_dir, f))]
    assert not missing, f"preprocessing did not write {missing}"
    masks = [read_png(os.path.join(data_dir, "mask", str(p), f"{i:04d}.png")) for p in range(PREP_PERSONS)
             for i in range(n_frames)]
    assert all(m.any() for m in masks), "an empty mask"
    H, W = PREP_HW[0] // 2, PREP_HW[1] // 2
    assert read_png(os.path.join(data_dir, "image", "0000.png")).shape == (H, W, 3) and masks[0].shape == (H, W)
    out.update(pnp_s=seconds["pnp"], refine_s=seconds["refine"], refine_frame_s=frame_s, finalize_s=seconds["finalize"],
               kp_err=(err0, err1), mask_share=[float((m > 0).mean()) for m in masks])
    log(f"path P preprocessing ({PREP_FRAMES} frames of {PREP_HW[0]}x{PREP_HW[1]}, {PREP_PERSONS} persons, "
        f"{PREP_VERTS}-vertex pickle; scaffold {out['scaffold_s']:.1f} s): PnP {seconds['pnp']:.3f} s, refinement "
        f"{seconds['refine']:.3f} s ({cfg.iters} iterations a frame; by frame {[round(x, 3) for x in frame_s]} s), "
        f"finalize {seconds['finalize']:.3f} s; keypoint error {err0:.3f} -> {err1:.3f} px; mask coverage "
        f"{[round(x, 3) for x in out['mask_share']]}")

    # ---- (4) training on that directory ----
    sets = ("dataset.train.end_frame=2", "model.num_training_frames=2", f"smpl_model_path={smpl_dir}",
            f"model.smpl_init_steps={PREP_SMPL_INIT_STEPS}", f"model.smpl_init_cache_dir={run_dir}")
    argv = ["--conf", os.path.join(ROOT, PREP_CONF), "--data_root", data_dir, "--run_dir", run_dir, "--device", dev,
            *(f"--set={s}" for s in sets)]
    bakes, smpl_init = [], []
    sdf_grid, apply_smpl_init = renderer_module.sdf_grid, trainer_module.Trainer._apply_smpl_init

    def timed_bake(verts, faces, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = sdf_grid(verts, faces, *args, **kw)
        torch.cuda.synchronize()
        bakes.append((time.perf_counter() - t0, tuple(faces.shape), result["grid"].shape[-1]))
        return result

    def timed_init(self, model_conf):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply_smpl_init(self, model_conf)
        torch.cuda.synchronize()
        smpl_init.append(time.perf_counter() - t0)

    renderer_module.sdf_grid, trainer_module.Trainer._apply_smpl_init = timed_bake, timed_init
    try:
        t0 = time.perf_counter()
        trainer, conf, ckpt_dir = cli_train.build_trainer(cli_train.parse_args(argv))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    finally:
        renderer_module.sdf_grid, trainer_module.Trainer._apply_smpl_init = sdf_grid, apply_smpl_init
    m, d = conf.model, conf.dataset.train
    widths = (f"SDF {len(m.implicit_network.dims)}x{m.implicit_network.dims[0]}, render "
              f"{len(m.rendering_network.dims)}x{m.rendering_network.dims[0]}, sampler "
              f"{m.ray_sampler.max_total_iters}x{m.ray_sampler.N_samples_eval} evals, {d.num_sample} rays a step, "
              f"{len(trainer.seq)} frames of {H}x{W}")
    assert list(m.implicit_network.dims) == [256] * 8 and list(m.rendering_network.dims) == [256] * 4, widths
    assert (m.ray_sampler.max_total_iters, m.ray_sampler.N_samples_eval, d.num_sample) == (5, 128, 512), widths
    assert len(trainer.seq) == n_frames and trainer.seq.get_eval_item(0)["img_size"] == (H, W), widths
    assert all(s.verts_c.shape == (PREP_VERTS, 3) for s in trainer.servers), "the trainer's body is not the pickle's"
    assert len(bakes) == PREP_PERSONS and all(b[1] == (2 * PREP_VERTS - 4, 3) for b in bakes), bakes
    assert len(smpl_init) == 1, smpl_init
    out.update(setup_s=setup_s, bake_s=[b[0] for b in bakes], bake_faces=bakes[0][1][0], bake_res=bakes[0][2],
               smpl_init_s=smpl_init[0])
    log(f"path P: training entry set-up {setup_s:.1f} s ({widths}), of it the canonical sdf_grid bakes "
        f"{[round(b[0], 3) for b in bakes]} s (res {bakes[0][2]}, {bakes[0][1][0]} faces each) and SMPL init "
        f"{smpl_init[0]:.1f} s ({PREP_SMPL_INIT_STEPS} steps)")

    kernel_inputs = {}
    held_shapes, failures, unhold = hold_kernels_on_path("P", kernel_inputs)
    steps, _, _ = instrument(trainer)
    spent, undo = profile_stages(trainer)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(PREP_EPOCHS, ckpt_dir=ckpt_dir)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = read_counts()
    undo()
    peak = max(pk for _, pk, _ in spent.values())
    assert len(steps) == PREP_EPOCHS * n_frames, f"path P took {len(steps)} steps"
    for ep, mode, expected, loss, skipped in steps:
        assert mode == expected, f"path P epoch {ep}: step mode {mode}, _select_mode gives {expected}"
        assert math.isfinite(loss) and skipped == 0.0, f"path P epoch {ep}: loss {loss}, update skipped {skipped}"
    expected_files = ["stage_instance_mask/00000/all_person_smpl_mask.npy", "stage_sam_mask/00000/sam_opt_mask.npy",
                      "val/epoch_00000.png", "checkpoints/epoch_00000", "checkpoints/last"]
    missing = [f for f in expected_files if not os.path.exists(os.path.join(run_dir, f))]
    assert not missing, f"path P training did not write {missing}"
    metrics = read_metrics(run_dir)
    epoch_s = {r["epoch"]: r["epoch_seconds"] for r in metrics if "epoch_seconds" in r}
    stage_s = {f"{k[:-8]}@{r['epoch']}": r[k] for r in metrics for k in r if k.endswith("_seconds") and k != "epoch_seconds"}
    nn1_v = sorted({key[2] for key in held_shapes if key[0] == "nn1"})
    assert PREP_VERTS in nn1_v and launches_fit["nn1"] > 0 and launches_fit["grid_trilinear"] > 0, \
        (nn1_v, launches_fit)
    out.update(fit_s=fit_s, epoch_s=epoch_s, stage_s=stage_s, launches_fit=launches_fit, peak_gib=peak,
               steps=len(steps), val_psnr=[r["val_psnr"] for r in metrics if "val_psnr" in r])
    log(f"path P: {PREP_EPOCHS} epochs in {fit_s:.1f} s, epoch seconds {epoch_s}, stages (seconds @ epoch) "
        f"{ {k: round(v, 3) for k, v in stage_s.items()} }, {len(steps)} steps, kernel launches {launches_fit}, peak "
        f"memory {peak:.3f} GiB, validation PSNR {out['val_psnr']}")

    # ---- (5) the test entry, then the visualisation of both frames ----
    t0 = time.perf_counter()
    test_dir = cli_test.main([*argv, "--frames", "1"])
    out["test_s"] = time.perf_counter() - t0
    assert read_png(os.path.join(test_dir, "test_rendering", "0000.png")).shape == (H, 2 * W, 3)
    unhold()
    out["launches"] = read_counts()
    assert not failures, f"path P: a kernel disagrees with its plain version: {failures}"

    t0 = time.perf_counter()
    seq, body = trainer.seq, trainer.ts.body
    images, meshes, projections = [], [], []
    faces = trainer.servers[0].model.faces.cpu().numpy()
    with torch.no_grad():
        for i in range(n_frames):
            item = seq.get_eval_item(i)
            posed = smpl_server_forward(trainer.person_state.server, torch.as_tensor(item["smpl_scale"], device=dev),
                                        body.transl[:, i], body.thetas(i), body.betas[:, 0])["smpl_verts"]
            images.append(item["rgb"].reshape(H, W, 3))
            meshes.append([(v, faces) for v in posed.cpu().numpy()])
            projections.append(np.asarray(seq.P[i]))
    vis_dir = os.path.join(root, "visualization")
    export_visualization(vis_dir, images, meshes, projections)
    out["vis_s"] = time.perf_counter() - t0
    cover = []
    for i in range(n_frames):
        shaded = np.abs(read_png(os.path.join(vis_dir, f"{i:04d}.png")).astype(np.int32)
                        - (np.clip(images[i], 0, 1) * 255).astype(np.int32)).sum(-1) > 0
        body_px = np.zeros((H, W), bool)
        for v, fc in meshes[i]:
            body_px |= np.isfinite(rasterize_depth(project_depth(projections[i], v).astype(np.float32), fc, W, H))
        cover.append(float((shaded & body_px).sum() / body_px.sum()))
    blocks = gif_image_blocks(os.path.join(vis_dir, "sequence.gif"))
    assert min(cover) > 0.95 and blocks == n_frames, (cover, blocks)
    out.update(vis_cover=cover)
    log(f"path P: test entry, 1 frame, {out['test_s']:.1f} s; visualisation of {n_frames} frames {out['vis_s']:.2f} s "
        f"(shaded share of the projected bodies {[round(c, 4) for c in cover]}, GIF89a with {blocks} image blocks); "
        f"launches over path P (training and test entries) {out['launches']}")

    # ---- (6) both kernels at the shapes the trainer handed them ----
    # nn1: a sampler round of a training step (rays x N_samples_eval points a person)
    n_step = d.num_sample * m.ray_sampler.N_samples_eval
    key_a = next(k for k in kernel_inputs if k[0] == "nn1" and k[2] == PREP_VERTS and k[1][-2] == n_step)
    q, r = kernel_inputs[key_a]
    key_b = next(k for k in kernel_inputs if k[0] == "grid_trilinear")
    a, b = time_kernels(q, r, kernel_inputs[key_b][:4], kernel_inputs[key_b][4])
    held_err = {k: max((e for key, e in held_shapes.items() if key[0] == k), default=None)
                for k in ("nn1", "grid_trilinear")}
    out.update(nn1=a, grid=b, held=held_shapes, held_err=held_err, path_s=time.perf_counter() - t_path,
               smpl_dir=smpl_dir)
    log(f"path P kernels at the trainer's shapes: nn1 {a['shape']}: call {a['ms']:.4f} ms, queued "
        f"{a['queued_ms']:.4f} ms, device (profiler) {a['device_ms']} ms, host {a['host_us']:.2f} us, bound "
        f"{a['bound_ms']:.4f} ms ({a['bound_by']}), plain {a['plain_ms']:.4f} ms, cdist+min {a['library_ms']:.4f} ms; "
        f"grid_trilinear {b['shape']}: call {b['ms']:.4f} ms, queued {b['queued_ms']:.4f} ms, device (profiler) "
        f"{b['device_ms']} ms, host {b['host_us']:.2f} us, bound {b['bound_ms']:.6f} ms ({b['bound_by']}), plain "
        f"{b['plain_ms']:.4f} ms, grid_sample+min {b['library_ms']:.4f} ms")
    log(f"path P: each kernel held to its plain version on the first call of each shape, max abs error by shape: "
        f"{ {' '.join(map(str, k)): float(f'{e:.3g}') for k, e in held_shapes.items()} }; whole path "
        f"{out['path_s']:.1f} s")
    del trainer, seq, body
    torch.cuda.empty_cache()
    return out


# ---- path V: the ViTPose model and JPEG frames ----

def _annex_k_ac(counts, head):
    """Annex K.3's AC tables: their first symbols as listed there, then every
    other (run, size) symbol in increasing order."""
    rest = sorted({0x00, 0xF0, *(r << 4 | s for r in range(16) for s in range(1, 11))} - set(head))
    return counts, list(head) + rest


# ITU-T T.81 Annex K.1: the quantisation tables for quality 50, natural order
K1_LUMA = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
           14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
K2_CHROMA = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
             47, 66, 99, 99, 99, 99, 99, 99) + (99,) * 32
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7,
          14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39,
          46, 53, 60, 61, 54, 47, 55, 62, 63)
# Annex K.3: (codes of each length 1-16, symbols) of DC luminance, DC chrominance, AC luminance, AC chrominance
ANNEX_K_HUFFMAN = (
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), list(range(12))),
    ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), list(range(12))),
    _annex_k_ac((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
                (1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129, 145, 161, 8, 35, 66,
                 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130)),
    _annex_k_ac((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
                (0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8, 20, 66, 145, 161, 177,
                 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36, 52, 225, 37, 241)),
)


def encode_jpeg(img, quality=JPEG_QUALITY):
    """Scaffolding for path V, whose machine has no JPEG encoder: a baseline
    JFIF file of an (H, W, 3) uint8 RGB image, 4:2:0 (Cb and Cr averaged over
    2x2), float DCT, the Annex K tables with the quantisation scaled to
    `quality` as libjpeg scales it, one interleaved scan."""
    import struct

    import numpy as np

    H, W, _ = img.shape
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((np.asarray(t) * scale + 50) // 100, 1, 255).astype(np.int64) for t in (K1_LUMA, K2_CHROMA)]
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    x = np.pad(img.astype(np.float64), ((0, Hp - H), (0, Wp - W), (0, 0)), mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128, 0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    planes[1:] = [p.reshape(Hp // 2, 2, Wp // 2, 2).mean((1, 3)) for p in planes[1:]]
    u = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * u[None] + 1) * u[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    coefs = []
    for p, qt in zip(planes, (qts[0], qts[1], qts[1])):
        blocks = (p - 128).reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        q = np.rint(dct @ blocks @ dct.T / qt.reshape(8, 8)).astype(np.int64)
        coefs.append(q.reshape(q.shape[0], q.shape[1], 64)[..., list(ZIGZAG)])
    codes = []
    for counts, symbols in ANNEX_K_HUFFMAN:  # canonical codes, as bit strings
        table, code, k = {}, 0, 0
        for length, n in enumerate(counts, 1):
            for _ in range(n):
                table[symbols[k]] = format(code, f"0{length}b")
                code, k = code + 1, k + 1
            code <<= 1
        codes.append(table)

    def magnitude(v):
        size = int(abs(v)).bit_length()
        return size, (format(v if v >= 0 else v + (1 << size) - 1, f"0{size}b") if size else "")

    bits, pred = [], [0, 0, 0]

    def block(zz, c):
        dc, ac = codes[0 if c == 0 else 1], codes[2 if c == 0 else 3]
        size, mag = magnitude(int(zz[0]) - pred[c])
        pred[c] = int(zz[0])
        bits.append(dc[size] + mag)
        last = 0
        for k in np.flatnonzero(zz[1:]) + 1:
            run = k - last - 1
            while run > 15:
                bits.append(ac[0xF0])
                run -= 16
            size, mag = magnitude(int(zz[k]))
            bits.append(ac[run << 4 | size] + mag)
            last = k
        if last < 63:
            bits.append(ac[0x00])

    for my in range(Hp // 16):
        for mx in range(Wp // 16):
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                block(coefs[0][2 * my + dy, 2 * mx + dx], 0)
            block(coefs[1][my, mx], 1)
            block(coefs[2][my, mx], 2)
    stream = "".join(bits)
    stream += "1" * (-len(stream) % 8)
    data = int(stream, 2).to_bytes(len(stream) // 8, "big").replace(b"\xff", b"\xff\x00")

    def segment(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    dqt = b"".join(bytes([i]) + bytes(int(t[z]) for z in ZIGZAG) for i, t in enumerate(qts))
    dht = b"".join(bytes([cls << 4 | tid]) + bytes(counts) + bytes(symbols)
                   for (counts, symbols), (cls, tid) in zip(ANNEX_K_HUFFMAN, ((0, 0), (0, 1), (1, 0), (1, 1))))
    return (b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") + segment(0xDB, dqt)
            + segment(0xC0, struct.pack(">BHHB", 8, H, W, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
            + segment(0xC4, dht) + segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])) + data
            + b"\xff\xd9")


def write_safetensors(path, state):
    """Scaffolding for path V: a state dict (f32 and int64 tensors) in the
    safetensors layout that `save_pretrained` writes."""
    import struct

    import torch

    names = {torch.float32: "F32", torch.int64: "I64"}
    header, offset, blobs = {}, 0, []
    for name, t in state.items():
        data = t.detach().contiguous().cpu().numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for data in blobs:
            f.write(data)


def vitpose_config_json(backbone, **top):
    """The `config.json` of a `VitPoseForPoseEstimation` directory."""
    layers = backbone["num_hidden_layers"]
    bb = {"model_type": "vitpose_backbone", "image_size": [256, 192], "patch_size": [16, 16], "num_channels": 3,
          "mlp_ratio": 4, "hidden_act": "gelu", "layer_norm_eps": 1e-6, "qkv_bias": True, "num_experts": 1,
          "out_indices": [layers], "out_features": [f"stage{layers}"], **backbone}
    return {"model_type": "vitpose", "architectures": ["VitPoseForPoseEstimation"], "backbone_config": bb,
            "use_simple_decoder": True, "scale_factor": 4,
            "id2label": {str(i): f"LABEL_{i}" for i in range(17)}, **top}


def random_vitpose(cfg, gen, dev):
    """A `VitPose` on `dev` with `transformers`' initialisation drawn from
    `gen`: weights of the linear and convolution layers and the position
    embedding truncated normal (std 0.02), biases 0, norms 1 and 0."""
    import torch

    from multiply_tpu_torch.models.vitpose import VitPose

    with torch.device("meta"):
        model = VitPose(cfg)
    model.to_empty(device=dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                torch.nn.init.trunc_normal_(p, std=0.02, generator=gen)
            elif "norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in model.named_buffers():
            b.fill_(1 if name.endswith("running_var") else 0)
    return model


def vitpose_flops(cfg, crops):
    """Multiply-adds x 2 of one forward over `crops` crops, from the shapes:
    the patch embedding, each encoder layer (q/k/v/output projections, the
    two attention products, the MLP) and the head (a stride-2 4x4 transposed
    convolution has 4 taps an output)."""
    gh, gw = cfg.grid
    n, c = gh * gw, cfg.hidden_size
    hidden = int(c * cfg.mlp_ratio)
    flops = 2 * n * c * cfg.num_channels * cfg.patch_size[0] * cfg.patch_size[1]
    flops += cfg.out_index * (2 * 4 * n * c * c + 2 * 2 * n * n * c + 2 * 2 * n * c * hidden)
    if cfg.use_simple_decoder:
        flops += 2 * (gh * cfg.scale_factor) * (gw * cfg.scale_factor) * c * 9 * cfg.num_labels
    else:
        flops += 2 * (2 * gh) * (2 * gw) * 256 * c * 4 + 2 * (4 * gh) * (4 * gw) * 256 * 256 * 4
        flops += 2 * (4 * gh) * (4 * gw) * 256 * cfg.num_labels
    return crops * flops


def run_path_v(smpl_dir):
    """Path V: the ViTPose model and JPEG frames. (a) the committed JPEG
    fixtures decoded bit for bit as OpenCV decodes them, and a 540x720
    frame's decode time; (b) ViTPose-H at its published widths with random
    weights from SEED, written as a `from_pretrained` directory and loaded by
    the detector: the card's heatmaps held to the same module's f32 forward
    on the CPU, the forward timed at P = 2 and 8 crops beside its bound, and
    one forward of the simple decoder at ViTPose-B widths; (c) the
    preprocessing entry on path P's scene with JPEG frames and `--vitpose`:
    every frame's boxes reach the detector, every keypoint handed to the
    refinement is finite, every file is written. Returns a dict of what it
    measured."""
    import gc
    import glob

    import numpy as np
    import torch

    from multiply_tpu_torch.models.vitpose import VitPoseConfig
    from multiply_tpu_torch.preprocessing import pipeline
    from multiply_tpu_torch.preprocessing import vitpose as vitpose_module
    from multiply_tpu_torch.preprocessing.__main__ import main as preprocess_main
    from multiply_tpu_torch.preprocessing.vitpose_processing import preprocess
    from multiply_tpu_torch.utils.io import read_png
    from multiply_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg

    dev = "cuda"
    root = os.path.join(ROOT, "outputs", "chip_smoke_path_v")
    shutil.rmtree(root, ignore_errors=True)
    ckpt, frames_dir, data_dir = (os.path.join(root, d) for d in ("vitpose_h", "frames_jpeg", "data"))
    os.makedirs(ckpt)
    out = {}
    gc.collect()  # earlier paths' trainers hold reference cycles: free their tensors before the peaks are read
    torch.cuda.empty_cache()
    zero_counts()
    t_path = time.perf_counter()
    try:
        # ---- (a) JPEG ----
        fixtures = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "torch_jpeg", "*.jpg")))
        assert len(fixtures) == 16, fixtures
        for path in fixtures:
            if not os.path.exists(path[:-4] + ".png"):  # a mode that OpenCV reads as None: refused
                try:
                    read_jpeg(path)
                except NotImplementedError:
                    continue
                raise AssertionError(f"{path}: decoded, where OpenCV reads none")
            got, want = read_jpeg(path), read_png(path[:-4] + ".png")
            assert got.shape == want.shape and np.array_equal(got, want), f"{path}: not OpenCV's pixels"
        with open(os.path.join(ROOT, "tests", "data", "torch_jpeg", "frame_540x720.jpg"), "rb") as f:
            frame_bytes = f.read()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            decode_jpeg(frame_bytes)
            times.append((time.perf_counter() - t0) * 1e3)
        out["decode_ms"] = median(times)
        log(f"path V JPEG: {len(fixtures)} fixtures decoded bit for bit as OpenCV decodes them "
            f"({', '.join(os.path.basename(p)[:-4] for p in fixtures)}); 540x720 4:2:0 frame decoded in "
            f"{out['decode_ms']:.3f} ms (host clock, median of 20)")

        # ---- (b) ViTPose-H at its published widths ----
        t0 = time.perf_counter()
        conf_h = vitpose_config_json(VITPOSE_H, use_simple_decoder=False)
        cfg = VitPoseConfig.from_dict(conf_h)
        gen = torch.Generator(dev).manual_seed(SEED)
        model = random_vitpose(cfg, gen, dev)
        with torch.no_grad():
            model.backbone.embeddings.position_embeddings.normal_(0.0, 0.02, generator=gen)
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(conf_h, f)
        write_safetensors(os.path.join(ckpt, "model.safetensors"), model.state_dict())
        out["n_params"] = sum(p.numel() for p in model.parameters())
        out["write_s"] = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        det = vitpose_module.VitPoseDetector(checkpoint=ckpt, device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        assert next(det.model.parameters()).device.type == "cuda" and det.cfg.hidden_size == 1280
        assert (det.processor.height, det.processor.width) == (256, 192) and det.cfg.out_index == 32
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        assert flags == (False, False), f"TF32 (matmul, cuDNN) {flags} with the ViTPose model built"
        log(f"path V ViTPose-H: {out['n_params'] / 1e6:.3f} M parameters, random weights written as a "
            f"from_pretrained directory in {out['write_s']:.1f} s "
            f"({os.path.getsize(os.path.join(ckpt, 'model.safetensors')) / 2**30:.3f} GiB), loaded by the "
            f"detector in {out['load_s']:.1f} s")

        # crops of path P's scene: the scene is written for (c), its boxes prompt every crop here
        npz, png_dir, kps = write_tracker_output(root, smpl_dir)
        images = [read_png(os.path.join(png_dir, f"{f:04d}.png")) for f in range(PREP_FRAMES)]
        boxes = []
        for f in range(PREP_FRAMES):
            for p in range(PREP_PERSONS):
                (x0, y0), (x1, y1) = kps[f, p, :, :2].min(0), kps[f, p, :, :2].max(0)
                boxes.append((f, [x0 - 0.2 * (x1 - x0), y0 - 0.2 * (y1 - y0), 1.4 * (x1 - x0), 1.4 * (y1 - y0)]))
        crops = np.concatenate([preprocess(images[f], np.asarray([b], np.float32), det.processor) for f, b in boxes])
        crops = np.concatenate([crops] * (max(VITPOSE_CROPS) // len(crops) + 1))[:max(VITPOSE_CROPS)]
        x = torch.from_numpy(crops).to(dev)
        cpu_model = copy.deepcopy(det.model).cpu()
        with torch.inference_mode():
            card = det.model(x[:VITPOSE_CHECK_CROPS]).cpu()
            t0 = time.perf_counter()
            ref = cpu_model(x[:VITPOSE_CHECK_CROPS].cpu())
            out["cpu_s"] = time.perf_counter() - t0
        del cpu_model
        assert card.shape == (VITPOSE_CHECK_CROPS, 17, 64, 48) and torch.isfinite(card).all(), card.shape
        scale = ref.abs().max().item()
        out["heatmap_err"] = (card - ref).abs().max().item()
        out["heatmap_scale"] = scale
        log(f"path V ViTPose-H heatmaps, {VITPOSE_CHECK_CROPS} crops: card vs CPU f32 max abs error "
            f"{out['heatmap_err']:.3e} over a heatmap scale {scale:.3e} (relative {out['heatmap_err'] / scale:.3e}, "
            f"bound {VITPOSE_REL_TOL:g}); CPU forward {out['cpu_s']:.1f} s")
        assert out["heatmap_err"] <= VITPOSE_REL_TOL * scale, "ViTPose-H: the card disagrees with the CPU"

        out["fwd"] = {}
        with torch.inference_mode():
            for n in VITPOSE_CROPS:
                xn = x[:n]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated() / 2**30  # the weights and the crops
                det.model(xn)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2**30
                ms = cuda_time_ms(lambda: det.model(xn), reps=20, warmup=3)
                gemm_ms, launches = device_time_ms(lambda: det.model(xn), "gemm", reps=3)
                flops = vitpose_flops(cfg, n)
                moved = out["n_params"] * 4 + xn.numel() * 4 + n * 17 * 64 * 48 * 4
                bound = max(flops / PEAK_FP32_FLOPS, moved / PEAK_BYTES) * 1e3
                out["fwd"][n] = {"ms": ms, "bound_ms": bound, "tflop": flops / 1e12, "peak_gib": peak, "held_gib": held,
                                 "launches": launches, "gemm_ms": gemm_ms,
                                 "bound_by": "operations" if flops / PEAK_FP32_FLOPS > moved / PEAK_BYTES else "bytes"}
                log(f"path V ViTPose-H forward, {n} crops of 256x192: {ms:.3f} ms (CUDA events, median of 20), "
                    f"bound {bound:.3f} ms ({out['fwd'][n]['bound_by']}: {flops / 1e12:.4f} TFLOP at 67 TFLOP/s f32), "
                    f"{bound / ms:.3f} of it; GEMM kernels {gemm_ms} ms (profiler); {launches:.0f} kernel launches; "
                    f"peak memory {peak:.3f} GiB, of it {held:.3f} GiB allocated before the forward")
            t0 = time.perf_counter()
            dets = det(images[0], np.asarray([b for f, b in boxes if f == 0], np.float32))
            out["frame_s"] = time.perf_counter() - t0
        assert len(dets) == PREP_PERSONS and all(d.shape == (17, 3) and np.isfinite(d).all() for d in dets)
        log(f"path V detector, one frame of {PREP_PERSONS} boxes (warp, forward, DARK): {out['frame_s'] * 1e3:.1f} ms")

        cfg_b = VitPoseConfig.from_dict(vitpose_config_json(VITPOSE_B))
        model_b = random_vitpose(cfg_b, gen, dev)
        with torch.inference_mode():
            hb = model_b(x[:2])
            out["b_ms"] = cuda_time_ms(lambda: model_b(x[:2]), reps=5, warmup=1)
        assert hb.shape == (2, 17, 64, 48) and torch.isfinite(hb).all(), hb.shape
        log(f"path V ViTPose-B, simple decoder: (2, 17, 64, 48) finite heatmaps, {out['b_ms']:.3f} ms for 2 crops")
        del model_b, det, x
        torch.cuda.empty_cache()

        # ---- (c) the preprocessing entry on JPEG frames with --vitpose ----
        os.makedirs(frames_dir)
        psnr = []
        for f, img in enumerate(images):
            data = encode_jpeg(img)
            with open(os.path.join(frames_dir, f"{f:04d}.jpg"), "wb") as fh:
                fh.write(data)
            mse = float(((decode_jpeg(data).astype(np.float64) - img) ** 2).mean())
            psnr.append(10 * math.log10(255 ** 2 / mse))
        assert min(psnr) > JPEG_MIN_PSNR, f"scaffold encoder: PSNR {psnr}"
        crops_seen, dets_seen, kept = [], [], {}
        call, refine_sequence = vitpose_module.VitPoseDetector.__call__, pipeline.refine_sequence

        def counted_call(self, image, boxes):
            crops_seen.append(len(boxes))
            result = call(self, image, boxes)
            dets_seen.extend(result)
            return result

        def kept_sequence(server, K, R, t, poses, transl, betas, keypoints_2d, cfg):
            kept["kp"] = keypoints_2d
            return refine_sequence(server, K, R, t, poses, transl, betas, keypoints_2d, cfg)

        vitpose_module.VitPoseDetector.__call__, pipeline.refine_sequence = counted_call, kept_sequence
        try:
            t0 = time.perf_counter()
            seconds = preprocess_main(["--trace", npz, "--frames", frames_dir, "--out", data_dir, "--vitpose", ckpt,
                                       "--smpl_model", os.path.join(smpl_dir, "SMPL_NEUTRAL.pkl"), "--focal",
                                       str(PREP_FOCAL), "--center", *map(str, PREP_CENTER), "--device", dev])
            out["entry_s"] = time.perf_counter() - t0
        finally:
            vitpose_module.VitPoseDetector.__call__, pipeline.refine_sequence = call, refine_sequence
        assert crops_seen == [PREP_PERSONS] * PREP_FRAMES, f"crops a frame {crops_seen}"
        kp = kept["kp"].cpu().numpy() if torch.is_tensor(kept["kp"]) else np.asarray(kept["kp"])
        assert kp.shape == (PREP_FRAMES, PREP_PERSONS, 17, 3) and np.isfinite(kp).all(), kp.shape
        missing = [f for f in (*pipeline.FILES, *(f"image/{i:04d}.png" for i in range(PREP_FRAMES)),
                               *(f"mask/{p}/{i:04d}.png" for p in range(PREP_PERSONS) for i in range(PREP_FRAMES)))
                   if not os.path.exists(os.path.join(data_dir, f))]
        assert not missing, f"the entry did not write {missing}"
        cleared = sum(float(d[:, 2].mean()) >= 0.3 for d in dets_seen)
        out.update(psnr=psnr, crops=sum(crops_seen), cleared=cleared, stage_s=seconds)
        log(f"path V entry: {PREP_FRAMES} JPEG frames of {PREP_HW[0]}x{PREP_HW[1]} (scaffold encoder, quality "
            f"{JPEG_QUALITY}, 4:2:0, PSNR {[round(p, 2) for p in psnr]} dB) with --vitpose: {sum(crops_seen)} crops "
            f"reached the detector, {cleared} of {len(dets_seen)} detections cleared conf_floor 0.3; every keypoint "
            f"handed to the refinement finite; every file written; {out['entry_s']:.1f} s (stages {seconds})")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["launches"] = read_counts()
    out["path_s"] = time.perf_counter() - t_path
    log(f"path V: {out['path_s']:.1f} s in all; launches of the port's kernels {out['launches']}")
    return out


# ---- path L: the example drivers at the invocations the JAX package's runlogs record ----

L_DIR = os.path.join("outputs", "chip_smoke_path_l")
L_DEMO_ARGS = ("--steps", "50", "--rays", "256")  # README.md's minimal demo
L_LONGRUN_ARGS = ("--epochs", "180", "--corrupt_masks", "--pose_noise", "0.05", "--segmenter", "color")
L_SCALING_ITERS = 5
L_SCALING_ARGS = ("--rays", "256", "--iters", str(L_SCALING_ITERS), "--worlds", "1,2")
# RUNLOG_CORRUPT.md (the JAX package on a host CPU, the same invocation): epoch, val PSNR, mask IoU, gt IoU,
# certain, delayed, transl rmse (cm), pose depth-order (segment max)
JAX_CORRUPT_ROWS = (
    (20, 17.81, 0.640, 0.748, 2, 2, 3.10, 0.0), (40, 18.40, 0.747, 0.873, 2, 2, 3.07, 0.0),
    (60, 18.09, 0.758, 0.873, 2, 2, 3.16, 0.0), (80, 17.70, 0.860, 0.997, 2, 2, 3.16, 27.67033),
    (100, 16.05, 0.865, 0.997, 2, 2, 3.18, 24.21874), (120, 16.97, 0.871, 0.995, 2, 0, 3.19, 18.57122),
    (140, 17.71, 0.864, 0.995, 2, 0, 3.18, 13.89528), (160, 17.35, 0.866, 0.994, 2, 0, 3.13, 28.41945),
    (180, 18.02, 0.865, 0.994, 2, 0, 3.08, 0.0),
)
JAX_IOU0 = 0.566  # RUNLOG_CORRUPT.md: the corrupted initial masks against ground truth
L_GT_IOU_MIN = 0.95  # gt IoU at every segment from epoch 100 on (JAX: 0.994-0.997)
L_RMSE_MAX_CM = 4.0  # translation rmse at epoch 180 (JAX: 3.08 cm)
L_PSNR_MIN = 16.5  # val PSNR at epoch 180 (JAX: 18.02 dB; its segments span 16.05-18.40)
# RUNLOG.md's opt_depth demo with the render anchor and silhouette 0.01: rmse total, view-axis, in-plane (cm), PSNR
JAX_OPTDEPTH = {"perturbed": (5.51, 5.28, 5.62, 18.28), "after": (5.95, 8.46, 4.17, 18.24)}
L_OPTDEPTH_PSNR_GAP = 1.0  # dB: the demo's PSNR after the pass against before (JAX: -0.04)
L_STAGES = ("mesh_refresh", "instance_mask", "sam", "validation", "opt_depth")
L_ONE_STATE_EPOCH = 100  # L2's state from which the step and every stage run on the card and on the CPU
L2_FINAL_PASS_ITERS = 10  # iterations a frame of L2's final opt_depth pass (the invocation's 40), for the script's time
# gt IoU >= L_GT_IOU_MIN at segments from epoch 100 on, over the keys 0-7 (tests/torch_init_study.py; PERF.md
# section 6): the JAX package's own driver on a host CPU, and the port on the card from JAX's weights
L_KEY_SHARE = {"jax": (5, 40), "port": (3, 40)}  # (segments held, segments) of each
L4_TIMEOUT_S = 600  # path L4's process, from the end of L3
L4_START = "spawn"  # its start method: CUDA needs spawn; a rehearsal on the CPU may fork to keep its stubs


def segment_stages(run_dir, lo, hi):
    """Seconds of each epoch-end stage that `metrics.jsonl` logs for epochs [lo, hi)."""
    out = dict.fromkeys(L_STAGES, 0.0)
    for rec in read_metrics(run_dir):
        if lo <= rec.get("epoch", -1) < hi:
            for name in L_STAGES:
                out[name] += rec.get(f"{name}_seconds", 0.0)
    return out


def steps_logged(run_dir):
    """Training steps of a trainer's run, from the per-mode counts in `metrics.jsonl`."""
    return int(sum(r["n_joint"] + r["n_pose_only"] + r["n_delayed_pose"] for r in read_metrics(run_dir)
                   if "n_joint" in r))


def l4_in_child(out_dir, result_path):
    """Path L4 in a spawned process of its own, so that it runs beside L1-L3
    on the one card: the mask refinement demo at its defaults with both
    kernels held on each new shape, the launch counters zeroed just before it
    and read just after. Writes (result, seconds, peak GiB, launches, held,
    failures) to `result_path`; the driver's output goes to L4.log beside it."""
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # the other half is the calling process's
    from multiply_tpu_torch.examples import mask_refinement_demo

    log_file = open(os.path.join(out_dir, "L4.log"), "w", buffering=1)
    sys.stdout.flush()
    os.dup2(log_file.fileno(), 1)
    sys.stdout = log_file
    held, failures, unhold = hold_kernels_on_path("L4")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        result = mask_refinement_demo.main(["--run_dir", os.path.join(out_dir, "maskdemo"),
                                            "--out", os.path.join(out_dir, "RUNLOG_MASKS.md")])
    finally:
        unhold()
    torch.cuda.synchronize()
    out = {"result": result, "seconds": time.perf_counter() - t0, "launches": read_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "held": held, "failures": failures}
    with open(result_path, "wb") as f:
        pickle.dump(out, f)


def run_path_l():
    """Path L: the five example drivers (`multiply_tpu_torch/examples/`) on
    the card at the invocations that README.md and the JAX package's runlogs
    record. L1 the minimal demo; L2 the corrupted long run (180 epochs),
    compared with RUNLOG_CORRUPT.md's rows by bands, the schedule's columns
    exactly; L3 the opt_depth demo on L2's run; L4 the mask refinement demo;
    L5 the scaling curve (1 NCCL rank, then 2 gloo ranks on cuda:0). Both
    kernels held to their plain versions on each new shape. The bands against
    the JAX package's recorded runs are printed with the ones missed (an open
    finding, ROADMAP.md section 3); every other failed check is recorded and
    raised after L5, so that one run shows every phase."""
    import numpy as np
    import torch

    from multiply_tpu_torch.examples import longrun_synthetic, one_state, optdepth_demo, scaling_curve, train_synthetic
    from multiply_tpu_torch.utils.io import read_png

    out_dir = os.path.join(ROOT, L_DIR)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t_path = time.perf_counter()
    problems, bands, phase_s, phase_launches = [], [], {}, {}
    kernel_inputs = {}
    held, failures, unhold = hold_kernels_on_path("L", kernel_inputs)

    def phase(name, fn):
        before = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t0
        phase_launches[name] = {k: n - before[k] for k, n in read_counts().items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if isinstance(result, dict) and "segments" in result:  # the long run resets the peak after each segment
            peak = max([peak, *(seg["peak_gib"] for seg in result["segments"])])
        log(f"path {name}: {phase_s[name]:.1f} s, peak memory {peak:.3f} GiB, "
            f"launches {phase_launches[name]} ({smi_line()})")
        return result

    # L4 runs in a process of its own beside L1-L3 (its launches are counted there)
    import multiprocessing

    l4_result = os.path.join(out_dir, "L4.pkl")
    l4_proc = multiprocessing.get_context(L4_START).Process(target=l4_in_child, args=(out_dir, l4_result))
    l4_proc.start()
    zero_counts()
    try:
        # ---- L1: the minimal demo ----
        png = os.path.join(out_dir, "demo.png")
        l1 = phase("L1", lambda: train_synthetic.main([*L_DEMO_ARGS, "--out", png]))
        losses = l1["losses"]
        first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        problems += [msg for ok, msg in [
            (all(math.isfinite(v) for v in losses), f"L1: non-finite loss {losses}"),
            (not any(l1["skipped"]), f"L1: skipped updates {l1['skipped']}"),
            (last10 < first10, f"L1: mean of the last 10 losses {last10} not below the first 10's {first10}"),
            (math.isfinite(l1["psnr"]), f"L1: PSNR {l1['psnr']}"),
            (read_png(png).shape == (36, 96, 3), "L1: the PNG is not GT | prediction at 36x48"),
        ] if not ok]
        log(f"path L1 (train_synthetic {' '.join(L_DEMO_ARGS)}): median step {median(l1['step_s'][1:]) * 1e3:.2f} ms "
            f"(first {l1['step_s'][0] * 1e3:.1f} ms), loss mean of the first 10 {first10:.5f} -> last 10 {last10:.5f}, "
            f"PSNR {l1['psnr']:.3f} dB, no update skipped: {not any(l1['skipped'])}")

        # ---- L2: the corrupted long run, segment by segment ----
        run_dir, runlog = os.path.join(out_dir, "longrun"), os.path.join(out_dir, "RUNLOG_CORRUPT.md")
        one_state_at = {}

        def keep_state(tr, row):
            if row["epoch"] == L_ONE_STATE_EPOCH:
                one_state_at.update(state=one_state.capture(tr), scene=tr.seq.scene)

        l2_args = longrun_synthetic.parse_args([*L_LONGRUN_ARGS, "--run_dir", run_dir, "--out", runlog])
        l2_conf = model_conf_with(longrun_synthetic.build_conf(l2_args), model__it_per_loop=L2_FINAL_PASS_ITERS)
        l2 = phase("L2", lambda: longrun_synthetic.run(l2_conf, l2_args, on_segment=keep_state))
        rows = l2["rows"]
        noise0 = float(np.abs(np.random.default_rng(0).uniform(-0.05, 0.05, (2, 4, 3)).astype(np.float32)).max())
        checks = [
            ([r["epoch"] for r in rows] == [j[0] for j in JAX_CORRUPT_ROWS], f"L2 segments {[r['epoch'] for r in rows]}"),
            (abs(l2["iou0"] - JAX_IOU0) <= 1e-3, f"L2: initial gt IoU {l2['iou0']} against JAX's {JAX_IOU0}"),
            (l2["transl_err0"] == noise0 and round(noise0 * 100, 1) == 5.0,
             f"L2: initial translation error {l2['transl_err0']} against the numpy draw's {noise0}"),
            (math.isfinite(l2["transl_delta"]) and math.isfinite(l2["psnr_after"]),
             f"L2: final opt_depth max |dtransl| {l2['transl_delta']}, PSNR after {l2['psnr_after']}"),
        ]
        for r in rows:
            e = r["epoch"]
            checks += [
                (r["certain"] == 2, f"L2 epoch {e}: certain {r['certain']} of 4, JAX 2"),
                (r["n_delayed_pose"] == (2.0 if e <= 100 else 0.0), f"L2 epoch {e}: delayed {r['n_delayed_pose']}"),
                (math.isfinite(r["psnr"]), f"L2 epoch {e}: val PSNR {r['psnr']}"),
            ]
            if e != 60:  # JAX reads 0 here in RUNLOG_CORRUPT.md and 14.96 in RUNLOG.md: printed, not checked
                pose = r["pose_depth_order_loss"]
                checks.append((pose > 0 if 80 <= e <= 160 else pose == 0.0, f"L2 epoch {e}: pose depth-order {pose}"))
            if e >= 100:
                bands.append((r["gt_iou"] >= L_GT_IOU_MIN, f"L2 epoch {e}: gt IoU {r['gt_iou']} < {L_GT_IOU_MIN}"))
        if rows:
            last = rows[-1]
            bands += [
                (last["transl_rmse_cm"] <= L_RMSE_MAX_CM, f"L2: transl rmse {last['transl_rmse_cm']} cm > {L_RMSE_MAX_CM}"),
                (last["psnr"] >= L_PSNR_MIN, f"L2: val PSNR {last['psnr']} dB < {L_PSNR_MIN} at {last['epoch']}"),
            ]
        problems += [msg for ok, msg in checks if not ok]
        # ---- the card against the CPU from L2's epoch-100 state: the step and every stage ----
        t0 = time.perf_counter()
        gaps = one_state.compare_devices(longrun_synthetic.build_conf(longrun_synthetic.parse_args([])),
                                         one_state_at["scene"], one_state_at["state"], ("cuda", "cpu"),
                                         os.path.join(out_dir, "one_state"))
        phase_s["L2 one state"] = time.perf_counter() - t0
        found = one_state.problems(gaps) + [f"{name} did not run: {gaps[name]}" for name in one_state.CHECKS
                                            if name not in gaps or "skipped" in gaps[name]]
        problems += [f"L2, card against CPU from epoch {L_ONE_STATE_EPOCH}'s state: {p}" for p in found]
        log(f"path L2, card against CPU from the epoch-{L_ONE_STATE_EPOCH} state ({phase_s['L2 one state']:.1f} s; "
            f"tolerances: loss terms {one_state.LOSS_RTOL} relative, gradients {one_state.GRAD_REL} of each leaf's "
            f"largest, grids {one_state.GRID_ABS}, instance masks {one_state.MASK_EDGE_PIXELS} edge pixels, keypoints "
            f"{one_state.KEYPOINT_PX} px, the SAM stage equal): {one_state.summary(gaps)}; beyond tolerance: {found}")
        log(f"path L2 (longrun_synthetic {' '.join(L_LONGRUN_ARGS)}): initial gt IoU {l2['iou0']:.4f} (JAX {JAX_IOU0}), "
            f"initial max |transl err| {l2['transl_err0'] * 100:.2f} cm (JAX 5.0); by segment, port | JAX "
            f"(RUNLOG_CORRUPT.md, the JAX package on a host CPU):")
        segments = l2["segments"]
        seconds = np.diff([0.0, *(r["wall_s"] for r in rows), l2["wall_s"]])
        for r, j, seg, sec in zip(rows, JAX_CORRUPT_ROWS, segments, seconds):
            lo = r["epoch"] - 20
            stages = segment_stages(run_dir, lo, r["epoch"])
            log(f"  epoch {r['epoch']}: PSNR {r['psnr']:.2f} | {j[1]:.2f}, mask IoU {r['mask_iou']:.3f} | {j[2]:.3f}, "
                f"gt IoU {r['gt_iou']:.3f} | {j[3]:.3f}, certain {r['certain']} | {j[4]}, delayed "
                f"{r['n_delayed_pose']:.0f} | {j[5]}, transl rmse {r['transl_rmse_cm']:.2f} | {j[6]:.2f} cm, pose "
                f"depth-order {r['pose_depth_order_loss']:.5f} | {j[7]:.5f}, pose interp "
                f"{r['pose_interpenetration_loss']:.5f}, loss {r['loss']:.4f}, sam {r['sam_mask_loss']:.4f}; "
                f"{sec:.2f} s, stages (s) { {k: round(v, 3) for k, v in stages.items()} }, peak "
                f"{seg['peak_gib']:.3f} GiB, launches {seg['launches']}")
        if len(segments) > len(rows):
            seg = segments[-1]
            log(f"  final opt_depth + validation: {seconds[-1]:.2f} s (the pass alone {l2['opt_depth_s']:.2f} s), peak "
                f"{seg['peak_gib']:.3f} GiB, launches {seg['launches']}; PSNR {l2['psnr_before']:.2f} -> "
                f"{l2['psnr_after']:.2f} dB, max |dtransl| {l2['transl_delta']:.5f}")

        # ---- L3: the opt_depth demo on L2's run ----
        l3 = phase("L3", lambda: optdepth_demo.main(["--run_dir", run_dir, "--out", runlog]))
        with open(os.path.join(run_dir, "optdepth_demo.json")) as f:
            saved = json.load(f)
        problems += [] if all(math.isfinite(v) for v in saved.values()) else [f"L3: {saved}"]
        bands.append((abs(l3["psnr1"] - l3["psnr0"]) <= L_OPTDEPTH_PSNR_GAP,
                      f"L3: PSNR {l3['psnr0']} -> {l3['psnr1']} dB, more than {L_OPTDEPTH_PSNR_GAP} dB apart"))
        (v0, v1), (i0, i1) = l3["view_rmse"], l3["in_plane_rmse"]
        log(f"path L3 (optdepth_demo, its defaults, {l3['frames']} frames): rmse total / view-axis / in-plane (cm), "
            f"PSNR (dB), port | JAX (RUNLOG.md, render anchor + silhouette 0.01):")
        log(f"  perturbed: {l3['rmse0'] * 100:.2f} / {v0 * 100:.2f} / {i0 * 100:.2f}, {l3['psnr0']:.2f} | "
            f"{' / '.join(map(str, JAX_OPTDEPTH['perturbed'][:3]))}, {JAX_OPTDEPTH['perturbed'][3]}")
        log(f"  after opt_depth: {l3['rmse1'] * 100:.2f} / {v1 * 100:.2f} / {i1 * 100:.2f}, {l3['psnr1']:.2f} | "
            f"{' / '.join(map(str, JAX_OPTDEPTH['after'][:3]))}, {JAX_OPTDEPTH['after'][3]}; the pass {l3['wall_s']:.2f} s")

        # ---- L4: the mask refinement demo, begun beside L1 in its own process ----
        mask_dir = os.path.join(out_dir, "maskdemo")
        l4_proc.join(L4_TIMEOUT_S)
        if l4_proc.exitcode != 0:
            raise RuntimeError(f"path L4's process ended with {l4_proc.exitcode} (its output: {out_dir}/L4.log)")
        with open(l4_result, "rb") as f:
            l4_out = pickle.load(f)
        l4 = l4_out["result"]
        phase_s["L4"], phase_launches["L4"] = l4_out["seconds"], l4_out["launches"]
        held.update({k: e for k, e in l4_out["held"].items() if e >= held.get(k, -1.0)})
        failures += l4_out["failures"]
        log(f"path L4: {l4_out['seconds']:.1f} s in its own process, begun beside L1, peak memory "
            f"{l4_out['peak_gib']:.3f} GiB, launches {l4_out['launches']} ({smi_line()})")
        m_rows = l4["rows"]
        bands.append((m_rows[-1]["sup_iou"] > l4["iou0"], f"L4: supervision IoU {l4['iou0']} -> {m_rows[-1]['sup_iou']}"))
        problems += [] if m_rows[0]["epoch"] == 20 and m_rows[0]["uncertain"] == l4["bad_frames"] else [
            f"L4: uncertain at epoch {m_rows[0]['epoch']} {m_rows[0]['uncertain']}, corrupted {l4['bad_frames']}"]
        log(f"path L4 (mask_refinement_demo, its defaults): supervision IoU {l4['iou0']:.3f} -> "
            f"{m_rows[-1]['sup_iou']:.3f}, corrupted frames {l4['bad_frames']}, by segment (epoch, supervision IoU, "
            f"uncertain, transl rmse cm, delayed, pose-only, PSNR, seconds): "
            f"{[(r['epoch'], round(r['sup_iou'], 3), r['uncertain'], round(r['transl_rmse'] * 100, 2), r['n_delayed'], r['n_pose_only'], round(r['psnr'], 2), round(r['wall_s'], 1)) for r in m_rows]}")

        # ---- L5: the scaling curve ----
        l5 = phase("L5", lambda: scaling_curve.main([*L_SCALING_ARGS, "--run_dir", os.path.join(out_dir, "scaling")]))
        t1, tn = l5[0]["step_s"], l5[-1]["step_s"]
        problems += [msg for ok, msg in [
            (all(math.isfinite(v) for r in l5 for v in r["losses"]), "L5: non-finite loss"),
            (all(isinstance(r["collectives"], int) for r in l5 if r["world"] > 1),
             f"L5: collectives differ between steps or ranks {[r['collectives_by_rank'] for r in l5]}"),
            (tn < 3.0 * t1, f"L5: PATHOLOGICAL, {tn * 1e3:.1f} ms at {l5[-1]['world']} ranks against {t1 * 1e3:.1f} ms"),
        ] if not ok]
        log(f"path L5 (scaling_curve {' '.join(L_SCALING_ARGS)}): "
            f"{[(r['world'], r['how'], round(r['first_s'], 2), round(r['step_s'] * 1e3, 2), r['collectives'], r['collectives_by_kind']) for r in l5]}")
    finally:
        unhold()
        if l4_proc.is_alive():
            l4_proc.terminate()
        l4_proc.join()
    launches = {k: n + phase_launches["L4"][k] for k, n in read_counts().items()}
    problems += [f"a kernel disagrees with its plain version: {f}" for f in failures]

    # ---- both kernels at L2's training-step shapes: kernel A at V = 386, kernel B at res 24 ----
    conf = longrun_synthetic.build_conf(longrun_synthetic.parse_args([]))
    rays, sampler, res = conf.dataset.train.num_sample, conf.model.ray_sampler, conf.model.cano_grid_res
    S = sampler.N_samples + sampler.N_samples_extra + 1  # render samples a ray
    key_a = next(k for k in kernel_inputs if k[0] == "nn1" and k[2] == 386 and k[1][-2] == rays * sampler.N_samples_eval)
    key_b = next(k for k in kernel_inputs if k[0] == "grid_trilinear" and k[2] == res and k[1][-2] == rays * S)
    a, b = time_kernels(*kernel_inputs[key_a], kernel_inputs[key_b][:4], kernel_inputs[key_b][4])
    held_err = {k: max((e for key, e in held.items() if key[0] == k), default=None) for k in ("nn1", "grid_trilinear")}
    problems += [f"path L held no call of {k}" for k, e in held_err.items() if e is None]
    steps = (len(l1["losses"]) + steps_logged(run_dir) + steps_logged(mask_dir)
             + sum(1 + L_SCALING_ITERS for _ in l5))
    log(f"path L kernels at L2's training-step shapes: nn1 {a['shape']}: call {a['ms']:.4f} ms, queued "
        f"{a['queued_ms']:.4f} ms, device (profiler) {a['device_ms']} ms, host {a['host_us']:.2f} us, bound "
        f"{a['bound_ms']:.5f} ms ({a['bound_by']}), plain {a['plain_ms']:.4f} ms, cdist+min {a['library_ms']:.4f} ms; "
        f"grid_trilinear {b['shape']}: call {b['ms']:.4f} ms, queued {b['queued_ms']:.4f} ms, device (profiler) "
        f"{b['device_ms']} ms, host {b['host_us']:.2f} us, bound {b['bound_ms']:.6f} ms ({b['bound_by']}), plain "
        f"{b['plain_ms']:.4f} ms, grid_sample+min {b['library_ms']:.4f} ms")
    log(f"path L: each kernel held to its plain version on the first call of each shape, max abs error by shape: "
        f"{ {' '.join(map(str, k)): float(f'{e:.3g}') for k, e in held.items()} }")
    log(f"path L: launches {launches} over {steps} training steps (L4 in its own process; L2 {phase_launches['L2']}); "
        f"seconds by phase { {k: round(v, 1) for k, v in phase_s.items()} }; whole path "
        f"{time.perf_counter() - t_path:.1f} s")
    missed = [msg for ok, msg in bands if not ok]
    log(f"path L bands against the JAX package's recorded runs: {len(bands) - len(missed)} of {len(bands)} held; "
        f"missed (f32 rounding amplified by discrete choices, PERF.md section 6): {missed}")
    late = [r for r in l2["rows"] if r["epoch"] >= 100]
    share = sum(r["gt_iou"] >= L_GT_IOU_MIN for r in late)
    log(f"path L2 gt IoU >= {L_GT_IOU_MIN} at {share} of its {len(late)} segments from epoch 100; over the keys 0-7 "
        f"(PERF.md section 6; held, segments): the JAX package's driver on a host CPU {L_KEY_SHARE['jax']}, the "
        f"port on the card from JAX's weights {L_KEY_SHARE['port']}")
    del kernel_inputs
    torch.cuda.empty_cache()
    assert not problems, f"path L: {problems}"
    return {"bands_missed": missed, "launches": launches, "launches_l2": phase_launches["L2"], "steps": steps, "nn1": a, "grid": b,
            "held": held, "held_err": held_err, "phase_s": phase_s, "seconds": time.perf_counter() - t_path}


# ---- path M: one person and three persons (the paper's multi-person scenes) ----

M_PERSONS = (3, 1)  # M1's person counts at the parity preset's widths
M_COMPOSITE_PERSONS = (1, 2, 3)  # the composite alone, timed at the step's shapes
M_CONF = os.path.join("confs", "synthetic_p3.yaml")  # M2: P = 3, every stage boundary within 60 epochs
M_SETS = ("model.it_per_loop=2",)  # opt_depth at epoch 30: 2 iterations a frame of the configured 100
M_STAGE_EPOCHS = {"mesh_refresh": (20, 40), "opt_depth": (30,), "instance_mask": (0, 50), "sam": (0, 50),
                  "validation": (0, 50)}


def overlapping(transl):
    """Each person after the first stepped in front of and into the one before it."""
    import numpy as np

    out = transl.copy()
    for p in range(1, out.shape[1]):
        out[:, p] = out[:, p - 1] + np.array([0.1, 0.0, -0.15], np.float32)
    return out


def time_composite(renderer, P, S, dev, seed):
    """The renderer's composite (`MultiplyRenderer.composite`) alone, forward and
    backward, at P persons x RAYS rays x S intervals, each form: (call ms by CUDA
    events, device ms and launches a call by the profiler) by form."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    ends = torch.sort(0.5 + 4.0 * torch.rand((P, RAYS, S), generator=g, device=dev), dim=-1).values
    fe = (0.05 * torch.rand((P, RAYS, S), generator=g, device=dev)).requires_grad_(True)
    rgb = torch.rand((P, RAYS, S, 3), generator=g, device=dev).requires_grad_(True)
    nrm = torch.randn((P, RAYS, S, 3), generator=g, device=dev).requires_grad_(True)

    def run():
        out = renderer.composite(fe, ends, rgb, nrm)
        loss = out["fg_rgb_values"].sum() + out["normal_values"].sum() + out["acc_map"].sum()
        return torch.autograd.grad(loss, (fe, rgb, nrm))

    times, keep = {}, renderer.composite_matmul
    for matmul in (True, False):
        renderer.composite_matmul = matmul
        with torch.no_grad():
            out = renderer.composite(fe, ends, rgb, nrm)
            assert float(out["acc_map"].max()) <= 1.0 + 1e-6, f"composite P={P}: acc_map above 1"
            err = (out["acc_person"].sum(-1) - out["acc_map"]).abs().max().item()
            assert err <= 1e-5, f"composite P={P}: acc_person does not sum to acc_map ({err})"
        ms = cuda_time_ms(run, reps=20)
        dev_ms, per_call = device_time_ms(run, "", reps=10)
        times["pairwise" if matmul else "sorted"] = {"ms": ms, "device_ms": dev_ms, "launches": per_call}
    renderer.composite_matmul = keep
    return times


def kernels_by_persons(q, verts, grid_args, S):
    """Both kernels at path M's person counts, on phase 4's inputs with the
    person axis (each kernel's gridDim.y) cut to one or extended to three:
    each held to its plain version (`nn1` also its exact build, `grid_trilinear`
    per point and fused over runs of S) and timed (`time_kernels`). Returns
    {P: {"nn1": ..., "grid_trilinear": ...}}."""
    from multiply_tpu_torch.ops import grid_cuda

    P, by_persons = q.shape[0], {}
    for Pm in M_PERSONS:
        pick = [p % P for p in range(Pm)]
        q_m, verts_m = q[pick].contiguous(), verts[pick].contiguous()
        err_m, nd_m = check_nn1(q_m, verts_m, f"nn1 P={Pm} V=386")
        args_m = tuple(x[pick].contiguous() for x in grid_args)
        err_m1 = (grid_cuda.grid_trilinear_kernel(*args_m) - grid_cuda.grid_trilinear_plain(*args_m)).abs().max().item()
        fused_m = grid_cuda.grid_trilinear_kernel(*args_m, group=S)
        assert fused_m.shape == (Pm, args_m[1].shape[1] // S), f"grid_trilinear P={Pm} fused: shape {tuple(fused_m.shape)}"
        err_mg = (fused_m - grid_cuda.grid_trilinear_plain(*args_m, group=S)).abs().max().item()
        assert max(err_m1, err_mg) <= 1e-5, f"grid_trilinear P={Pm}: max abs error {max(err_m1, err_mg)} > 1e-5"
        a_m, b_m = time_kernels(q_m, verts_m, args_m, S)
        by_persons[Pm] = {"nn1": {**a_m, "max_abs_err": err_m, "tie_swaps": nd_m},
                          "grid_trilinear": {**b_m, "max_abs_err": max(err_m1, err_mg)}}
        log(f"P={Pm}: nn1 max|d2 err| {err_m:.3g} ({nd_m} tie swaps), {a_m['ms']:.4f} ms a call, device "
            f"{a_m['device_ms']} ms, bound {a_m['bound_ms']:.5f} ms, plain {a_m['plain_ms']:.4f} ms; grid_trilinear "
            f"max abs err {err_m1:.3g} (group=1), {err_mg:.3g} (group={S}), {b_m['ms']:.4f} ms a call, device "
            f"{b_m['device_ms']} ms, bound {b_m['bound_ms']:.6f} ms, plain {b_m['plain_ms']:.4f} ms")
    return by_persons


def run_path_m1():
    """M1: full-width training steps of the parity preset at P = 3 (both
    composites, then pose-only steps with a `PoseLossBatch` of three
    overlapping bodies) and at P = 1, each on its own synthetic scene with its
    grids baked at res 64; the composite alone at P = 1, 2, 3. Returns what it
    measured, by person count and form."""
    import numpy as np
    import torch

    from multiply_tpu_torch.config import load_config
    from multiply_tpu_torch.data.synthetic import make_scene
    from multiply_tpu_torch.engine.train import MODE_POSE_ONLY, TrainStep
    from multiply_tpu_torch.models.loss import LossConfig
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    dev, F_ = "cuda", 4
    conf = load_config(os.path.join(ROOT, "confs", "model", "taichi01_model.yaml"))
    out, launches, steps = {}, {}, {}
    for P in M_PERSONS:
        t0 = time.perf_counter()
        scene = make_scene(num_frames=F_, num_persons=P, height=32, width=40, seed=SEED, device=dev)
        gen = torch.Generator(dev).manual_seed(SEED)
        renderer = MultiplyRenderer(conf, num_persons=P, num_frames=F_, generator=gen, device=dev)
        state = renderer.build_person_state(scene.servers, grid_res=64)
        stepper = TrainStep(renderer, state, LossConfig(sam_start_epoch=0), learning_rate=conf.learning_rate)
        torch.cuda.synchronize()
        log(f"path M1 P={P}: scene + grid bake (res 64) {time.perf_counter() - t0:.1f} s")
        for matmul in ((True, False) if P == 3 else (True,)):
            name = f"p{P}" + ("" if matmul else "_sorted")
            renderer.composite_matmul = matmul
            ts = stepper.init_state(body_tables(scene, dev))
            before = {k: p.detach().clone() for k, p in ts.params().items()}
            rng = np.random.default_rng(SEED)
            batches = [make_batch(scene, i % F_, rng, dev) for i in range(STEPS)]
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            ts, step_s, _ = run_steps(f"M1 {name}", stepper, ts, batches, gen)
            launches[name], steps[name] = read_counts(), STEPS
            peak = torch.cuda.max_memory_allocated() / 2**30
            assert launches[name] == {"nn1": 8 * STEPS, "grid_trilinear": STEPS}, f"M1 {name}: launches {launches[name]}"
            unchanged = {k for k, p in ts.params().items() if torch.equal(p, before[k])}
            assert unchanged <= {"net.fg_render.lin_pose.weight"}, f"M1 {name}: params unchanged: {unchanged}"
            batch = make_batch(scene, STEPS % F_, rng, dev)
            wall, busy, _, _, n_launch, _ = step_breakdown(lambda: stepper.step(ts, batch, generator=gen))
            out[name] = {"median_ms": median(step_s[1:]) * 1e3, "min_ms": min(step_s[1:]) * 1e3,
                         "max_ms": max(step_s[1:]) * 1e3, "first_ms": step_s[0] * 1e3, "peak_gib": peak,
                         "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall, "launches": n_launch}
            log(f"path M1 {name}: median step {out[name]['median_ms']:.2f} ms over steps 1..{STEPS - 1}, range "
                f"{out[name]['min_ms']:.2f}-{out[name]['max_ms']:.2f} ms, step 0 {out[name]['first_ms']:.1f} ms, "
                f"peak {peak:.3f} GiB; profiled wall {wall:.2f} ms, device busy {busy:.2f} ms (idle share "
                f"{1 - busy / wall:.3f}), {n_launch} kernel launches")
        renderer.composite_matmul = True
        if P == 3:
            loss_p = LossConfig.from_config(conf.loss)._replace(sam_start_epoch=0)
            stepper_p = TrainStep(renderer, state, loss_p, learning_rate=conf.learning_rate,
                                  interp_samples=INTERP_SAMPLES)
            ts_p = stepper_p.init_state(body_tables(scene, dev, overlapping(scene.transl)))
            rng = np.random.default_rng(SEED)
            frames = [i % F_ for i in range(STEPS_POSE)]
            batches = [make_batch(scene, f, rng, dev, mode=MODE_POSE_ONLY) for f in frames]
            pose_batches = [pose_loss_batch(scene, f, rng, dev) for f in frames]
            before = {k: p.detach().clone() for k, p in ts_p.params().items()}
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            ts_p, step_s, logs = run_steps("M1 p3_pose", stepper_p, ts_p, batches, gen, pose_batches)
            launches["p3_pose"], steps["p3_pose"] = read_counts(), STEPS_POSE
            peak = torch.cuda.max_memory_allocated() / 2**30
            assert launches["p3_pose"] == {"nn1": 9 * STEPS_POSE, "grid_trilinear": STEPS_POSE}, launches["p3_pose"]
            assert logs["pose_depth_order_loss"] > 0 and logs["pose_interpenetration_loss"] > 0, logs
            moved = {k for k, p in ts_p.params().items() if not torch.equal(p, before[k])}
            assert moved == {k for k in before if k.startswith("body.")}, f"M1 p3_pose moved {sorted(moved)}"
            wall, busy, _, _, n_launch, _ = step_breakdown(
                lambda: stepper_p.step(ts_p, batches[0], generator=gen, pose_batch=pose_batches[0]))
            out["p3_pose"] = {"median_ms": median(step_s[1:]) * 1e3, "min_ms": min(step_s[1:]) * 1e3,
                              "max_ms": max(step_s[1:]) * 1e3, "first_ms": step_s[0] * 1e3, "peak_gib": peak,
                              "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall, "launches": n_launch,
                              "pose_terms": {k: logs[k] for k in logs if k.startswith("pose_")}}
            log(f"path M1 p3_pose: median step {out['p3_pose']['median_ms']:.2f} ms over steps 1..{STEPS_POSE - 1}, "
                f"range {out['p3_pose']['min_ms']:.2f}-{out['p3_pose']['max_ms']:.2f} ms, peak {peak:.3f} GiB; "
                f"profiled wall {wall:.2f} ms, device busy {busy:.2f} ms (idle share {1 - busy / wall:.3f}), "
                f"{n_launch} launches; last pose terms {out['p3_pose']['pose_terms']}")
            del stepper_p, ts_p, pose_batches
        cfg = renderer.sampler_cfg
        S = cfg.N_samples + cfg.N_samples_extra + 1
        if P == 3:
            out["composite"] = {Pc: time_composite(renderer, Pc, S, dev, SEED + Pc) for Pc in M_COMPOSITE_PERSONS}
            log(f"path M1 composite alone (forward + backward, {RAYS} rays x {S} intervals a person): "
                f"{out['composite']}")
        del renderer, state, stepper, ts, scene
        torch.cuda.empty_cache()
    out["launches"], out["steps"] = launches, steps
    return out


def run_path_m2():
    """M2: the training entry's code on `confs/synthetic_p3.yaml` (three
    persons, 4 frames of 48x64, 60 epochs: the mesh refresh at 20 and 40,
    pose correction until 24, opt_depth at 30, instance masks + the SAM stage
    and validation at 0 and 50) with the segmenter the entry picks, then one
    frame of the test entry. Every step's loss finite, no update skipped, its
    mode `_select_mode`'s, one `grid_trilinear` and the sampler's `nn1`
    launches a step; the stages' files with P = 3 in their shapes and all
    three persons' meshes; each kernel held to its plain version on each new
    shape. Returns what it measured."""
    import numpy as np
    import torch

    from multiply_tpu_torch.cli import test as cli_test
    from multiply_tpu_torch.cli import train as cli_train
    from multiply_tpu_torch.engine.sam_stage import PriorSegmenter
    from multiply_tpu_torch.utils.io import read_png

    dev = "cuda"
    run_dir = os.path.join(ROOT, "outputs", "chip_smoke_path_m")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--conf", os.path.join(ROOT, M_CONF), "--run_dir", run_dir, "--device", dev,
            *(f"--set={s}" for s in M_SETS)]
    t0 = time.perf_counter()
    trainer, conf, ckpt_dir = cli_train.build_trainer(cli_train.parse_args(argv))
    setup_s = time.perf_counter() - t0
    m, d = conf.model, conf.dataset.train
    epochs, n_frames, P = int(conf.max_epochs), len(trainer.seq), trainer.num_person
    assert (P, n_frames, d.height, d.width, epochs) == (3, 4, 48, 64, 60), (P, n_frames, d.height, d.width, epochs)
    assert list(m.depth_epoch) == [30] and m.depth_end and m.pose_correction_epoch == 24, "synthetic_p3 schedule"
    assert isinstance(trainer.segmenter, PriorSegmenter), f"the entry picked {type(trainer.segmenter).__name__}"
    nn1_a_step = m.ray_sampler.max_total_iters + 3  # the sampler's rounds, the render samples, two surface warps
    log(f"path M2: set-up {setup_s:.1f} s (P={P}, {n_frames} frames of {d.height}x{d.width}, {d.num_sample} rays a "
        f"step, SDF {len(m.implicit_network.dims)}x{m.implicit_network.dims[0]}, bf16 sampler {m.sampler_bf16}, "
        f"grid res {m.cano_grid_res}, {epochs} epochs, opt_depth {trainer.it_per_loop} iterations a frame)")

    held_shapes, failures, unhold = hold_kernels_on_path("M")
    steps, depth, _ = instrument(trainer)
    step_launches, counted = [], trainer.builder.step

    def step_counted(ts, batch, **kw):
        c0 = read_counts()
        out = counted(ts, batch, **kw)
        c1 = read_counts()
        step_launches.append({k: c1[k] - c0[k] for k in c1})
        return out

    trainer.builder.step = step_counted
    spent, undo = profile_stages(trainer)
    grid_before = trainer.person_state.cano_grid["grid"].clone()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit(epochs, ckpt_dir=ckpt_dir)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    undo()
    peak = max(pk for _, pk, _ in spent.values())
    assert len(steps) == epochs * n_frames, f"path M2 took {len(steps)} steps"
    for ep, mode, expected, loss, skipped in steps:
        assert mode == expected, f"path M2 epoch {ep}: step mode {mode}, _select_mode gives {expected}"
        assert math.isfinite(loss) and skipped == 0.0, f"path M2 epoch {ep}: loss {loss}, update skipped {skipped}"
    bad = [c for c in step_launches if c != {"nn1": nn1_a_step, "grid_trilinear": 1}]
    assert not bad, f"path M2: steps launched {bad[:3]} (expected nn1 {nn1_a_step}, grid_trilinear 1)"
    assert len(depth) == n_frames * trainer.it_per_loop and all(math.isfinite(v) for v in depth), depth
    grid_after = trainer.person_state.cano_grid["grid"]
    assert trainer.builder.state.cano_grid["grid"] is grid_after, "the step does not read the refreshed grid"
    for p in range(P):
        assert not torch.equal(grid_before[p], grid_after[p]), f"mesh refresh left person {p}'s grid as it was"
    for ep in M_STAGE_EPOCHS["instance_mask"]:
        stage = os.path.join(run_dir, "stage_instance_mask", f"{ep:05d}")
        masks = np.load(os.path.join(stage, "all_person_smpl_mask.npy"))
        kps = np.load(os.path.join(stage, "2d_keypoint.npy"))
        sam = np.load(os.path.join(run_dir, "stage_sam_mask", f"{ep:05d}", "sam_opt_mask.npy"))
        assert masks.shape == sam.shape == (n_frames, P, d.height, d.width), (masks.shape, sam.shape)
        assert kps.shape == (n_frames, P, 27, 2) and np.isfinite(sam).all(), kps.shape
        assert all(masks[:, p].any() for p in range(P)), f"epoch {ep}: a person has no instance-mask pixel"
    expected_files = [
        *(f"val/epoch_{ep:05d}_person_{p}.ply" for ep in M_STAGE_EPOCHS["validation"] for p in range(P)),
        *(f"val/epoch_{ep:05d}.png" for ep in M_STAGE_EPOCHS["validation"]),
        *(f"stage_depth_map/00030/{it:05d}/{kind}/{kind}_{f:04d}.png"
          for it in (0, trainer.it_per_loop - 1) for kind in ("front", "gt") for f in range(n_frames)),
        "checkpoints/last",
    ]
    missing = [f for f in expected_files if not os.path.exists(os.path.join(run_dir, f))]
    assert not missing, f"path M2 did not write {missing}"
    metrics = read_metrics(run_dir)
    epoch_s = {r["epoch"]: r["epoch_seconds"] for r in metrics if "epoch_seconds" in r}
    stage_s = {f"{k[:-8]}@{r['epoch']}": r[k] for r in metrics for k in r if k.endswith("_seconds") and k != "epoch_seconds"}
    want = {f"{name}@{ep}" for name, eps in M_STAGE_EPOCHS.items() for ep in eps}
    assert want <= set(stage_s), f"path M2: stages not run {sorted(want - set(stage_s))}"
    psnr = [r["val_psnr"] for r in metrics if "val_psnr" in r]
    assert len(psnr) == 2 and all(math.isfinite(v) for v in psnr), f"validation PSNR {psnr}"
    staged = {int(k.split("@")[1]) for k in stage_s}
    plain = [s for ep, s in epoch_s.items() if ep not in staged and ep != 0]

    t0 = time.perf_counter()
    test_dir = cli_test.main([*argv, "--frames", "1"])
    test_s = time.perf_counter() - t0
    img = read_png(os.path.join(test_dir, "test_rendering", "0000.png"))
    assert img.shape == (d.height, 2 * d.width, 3), img.shape
    unhold()
    assert not failures, f"path M: a kernel disagrees with its plain version: {failures}"
    held_err = {k: max((e for key, e in held_shapes.items() if key[0] == k), default=None)
                for k in ("nn1", "grid_trilinear")}
    assert all(e is not None for e in held_err.values()), f"path M held no call of {held_err}"
    modes = {mode: sum(1 for s in steps if s[1] == mode) for mode in sorted({s[1] for s in steps})}
    out = {"setup_s": setup_s, "fit_s": fit_s, "epoch_median_s": median(plain), "epoch_min_s": min(plain),
           "epoch_max_s": max(plain), "stage_s": stage_s, "test_s": test_s, "peak_gib": peak, "val_psnr": psnr,
           "launches": launches, "steps": len(steps), "modes": modes, "nn1_a_step": nn1_a_step,
           "held": held_shapes, "held_err": held_err}
    log(f"path M2: {epochs} epochs in {fit_s:.1f} s, median epoch without a stage {out['epoch_median_s']:.3f} s "
        f"(range {out['epoch_min_s']:.3f}-{out['epoch_max_s']:.3f}, epoch 0 {epoch_s[0]:.3f}), stages (seconds @ "
        f"epoch) { {k: round(v, 3) for k, v in stage_s.items()} }, steps by mode {modes}, launches over the fit "
        f"{launches} ({nn1_a_step} nn1 and 1 grid_trilinear in each of {len(steps)} steps), peak memory "
        f"{peak:.3f} GiB, validation PSNR {psnr}; test entry, 1 frame, {test_s:.1f} s")
    log(f"path M2: each kernel held to its plain version on the first call of each shape, max abs error by shape: "
        f"{ {' '.join(map(str, k)): float(f'{e:.3g}') for k, e in held_shapes.items()} }")
    return out


# ---- path N: stage overlap, and the configurations that had run only on the CPU ----

N_DIR = os.path.join("outputs", "chip_smoke_path_n")
N_OVERLAP_CONF = os.path.join("confs", "synthetic_base.yaml")
N_EPOCHS = 42  # epochs 0-41: overlapped mesh refreshes at 20 and 40, the overlapped mask + SAM stage at 0
N_GRID_TOL = 1e-5  # a harvested grid against the main thread's bake of its snapshot, where not bit for bit
N_POSE_EPOCH = 30  # synthetic_p3's pose window with `depth_end` off, as tests/test_torch_persons_program.py runs it


def run_path_n():
    """Path N. N1: the training entry's code on `synthetic_base.yaml` with
    `model.stage_overlap` to epoch 41: each mesh refresh baked on the stage
    worker and harvested later, each harvested grid held to the main thread's
    bake of the same snapshot, the step after a harvest reading the new grid,
    the mask + SAM stage of epoch 0 on the worker, every step's loss finite
    and mode `_select_mode`'s. N2: one `SamSegmenter` stage with `vit_h` at
    random weights (path S's draw) on `synthetic_p3.yaml`'s frames, whose
    prompts pass 64 points, and its first frame on the CPU with the same
    weights. N3: a pose-only epoch at P = 3 with `depth_end` off. N4: a
    full-width delayed-pose step on edge-sampled rays of path P's directory.
    Both kernels held to their plain versions on each new shape; the launch
    counts set to 0 before and read after. Returns what it measured."""
    import threading

    import numpy as np
    import torch

    from multiply_tpu_torch.cli import train as cli_train
    from multiply_tpu_torch.data.dataset import sam_iou_certainty
    from multiply_tpu_torch.engine.instance_masks import build_sam_prompts
    from multiply_tpu_torch.engine.sam_stage import SamSegmenter
    from multiply_tpu_torch.engine.train import MODE_DELAYED_POSE, MODE_POSE_ONLY
    from multiply_tpu_torch.models import sam as sam_model

    dev = "cuda"
    root = os.path.join(ROOT, N_DIR)
    shutil.rmtree(root, ignore_errors=True)
    out, problems, phase_s = {}, [], {}
    held, failures, unhold = hold_kernels_on_path("N")
    zero_counts()
    t_path = time.perf_counter()
    try:
        # ---- N1: stage overlap ----
        t0 = time.perf_counter()
        run_dir = os.path.join(root, "overlap")
        argv = ["--conf", os.path.join(ROOT, N_OVERLAP_CONF), "--run_dir", run_dir, "--device", dev, "--max_epochs",
                str(N_EPOCHS), "--set=model.stage_overlap=true"]
        args = cli_train.parse_args(argv)
        trainer, conf, ckpt_dir = cli_train.build_trainer(args)
        assert conf.model.stage_overlap, "model.stage_overlap is off"
        n_frames = len(trainer.seq)
        steps, _, _ = instrument(trainer)
        bakes, applied, epochs, stages, step_grids = [], [], [], [], []
        compute, apply, epoch_fn = trainer._compute_canonical_grids, trainer._apply_canonical_grids, trainer.train_epoch
        mask_fn, sam_fn, step_fn = trainer.instance_mask_stage, trainer.sam_stage, trainer.builder.step
        make_fn, made = trainer.make_batch, []

        def made_batch(item, mode):  # the producer's mode against _select_mode on the item it was made for
            made.append((mode, trainer._select_mode(item.get("is_certain", True), "sam_mask" in item)))
            return make_fn(item, mode)

        def on_worker():
            return threading.current_thread() is not threading.main_thread()

        def baked(params=None):
            t = time.perf_counter()
            grids = compute(params)
            torch.cuda.synchronize()
            bakes.append({"worker": on_worker(), "params": params, "grids": grids, "t": (t, time.perf_counter())})
            return grids

        def harvested(stacked):
            before = trainer.person_state.cano_grid["grid"]
            apply(stacked)
            applied.append({"epoch": trainer.epoch, "grid": stacked["grid"], "before": before, "next_step": len(steps)})

        def timed_epoch():
            t = time.perf_counter()
            logs = epoch_fn()
            torch.cuda.synchronize()
            epochs.append((trainer.epoch, t, time.perf_counter()))
            return logs

        def stage(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                fn(*a, **kw)
                stages.append((name, kw.get("epoch"), on_worker(), time.perf_counter() - t))
            return run

        def step_reading_grid(ts, batch, **kw):
            step_grids.append(trainer.builder.state.cano_grid["grid"])
            return step_fn(ts, batch, **kw)

        trainer._compute_canonical_grids, trainer._apply_canonical_grids = baked, harvested
        trainer.train_epoch, trainer.builder.step = timed_epoch, step_reading_grid
        trainer.instance_mask_stage, trainer.sam_stage = stage("instance_mask", mask_fn), stage("sam", sam_fn)
        trainer.make_batch = made_batch
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        cli_train.run(trainer, args, conf, ckpt_dir)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() / 2**30
        worker_bakes = [b for b in bakes if b["worker"]]
        problems += [msg for ok, msg in [
            (len(steps) == len(made) == N_EPOCHS * n_frames,
             f"N1: {len(steps)} steps of {len(made)} batches, {N_EPOCHS * n_frames} expected"),
            (len(worker_bakes) == 2 and len(bakes) == 2, f"N1: {len(worker_bakes)} of {len(bakes)} bakes on the worker"),
            (len(applied) == 2, f"N1: {len(applied)} harvests applied, 2 expected"),
            (sorted((n, ep, w) for n, ep, w, _ in stages) == [("instance_mask", 0, True), ("sam", 0, True)],
             f"N1: stages {stages}"),
        ] if not ok]
        # with the stages overlapped, the SAM pickup can change between a batch and its step: each step's mode
        # is held to `_select_mode` on the certainty of the item its batch was made from
        for (ep, mode, _, loss, skipped), (made_mode, expected) in zip(steps, made):
            if mode != made_mode or mode != expected or not math.isfinite(loss) or skipped:
                problems.append(f"N1 epoch {ep}: mode {mode} (expected {expected}), loss {loss}, skipped {skipped}")
        grid_gaps, bitwise = [], []
        for b, h in zip(worker_bakes, applied):
            again = compute(b["params"])  # the same snapshot, baked on the main thread
            gap = max(float((again[k] - b["grids"][k]).abs().max()) for k in again)
            grid_gaps.append(gap)
            bitwise.append(all(torch.equal(again[k], b["grids"][k]) for k in again))
            if gap > N_GRID_TOL:
                problems.append(f"N1: a harvested grid is {gap} from the main thread's bake of its snapshot")
            if h["grid"] is not b["grids"]["grid"]:
                problems.append(f"N1: the harvest at epoch {h['epoch']} applied another grid than the worker's")
            for p in range(h["grid"].shape[0]):
                if torch.equal(h["grid"][p], h["before"][p]):
                    problems.append(f"N1: the harvest at epoch {h['epoch']} left person {p}'s grid as it was")
            if h["next_step"] < len(step_grids) and step_grids[h["next_step"]] is not h["grid"]:
                problems.append(f"N1: the step after the harvest at epoch {h['epoch']} read another grid")
        files = [*(f"stage_instance_mask/00000/{f}" for f in ("all_person_smpl_mask.npy", "2d_keypoint.npy")),
                 "stage_sam_mask/00000/sam_opt_mask.npy", "val/epoch_00000.png", "checkpoints/last"]
        missing = [f for f in files if not os.path.exists(os.path.join(run_dir, f))]
        problems += [f"N1 did not write {missing}"] if missing else []
        if trainer.seq._sam_masks is None:
            problems.append("N1: the sequence never picked up the overlapped SAM stage's masks")
        spans = [b["t"] for b in worker_bakes]
        overlapped = {ep: t1_ - t0_ for ep, t0_, t1_ in epochs if any(a < t1_ and t0_ < b_ for a, b_ in spans)}
        alone = {ep: t1_ - t0_ for ep, t0_, t1_ in epochs if ep not in overlapped and ep not in (0, 20, 40)}
        out["n1"] = {"fit_s": fit_s, "peak_gib": peak, "bake_s": [b - a for a, b in spans], "grid_gaps": grid_gaps,
                     "bitwise": bitwise, "overlapped": overlapped, "alone_median_s": median(list(alone.values())),
                     "stages": stages, "steps": len(steps)}
        phase_s["N1"] = time.perf_counter() - t0
        log(f"path N1 (the training entry, synthetic_base.yaml, model.stage_overlap, epochs 0-{N_EPOCHS - 1}): fit "
            f"{fit_s:.1f} s, {len(steps)} steps (modes {_select_counts(steps)}), peak memory {peak:.3f} GiB; bakes on "
            f"the worker {[round(b - a, 2) for a, b in spans]} s, harvested at epochs {[h['epoch'] for h in applied]}, "
            f"each against the main thread's bake of its snapshot: bit for bit {bitwise}, max |gap| {grid_gaps}; the "
            f"mask + SAM stage (worker, epoch, seconds) {[(n, w, ep, round(s, 3)) for n, ep, w, s in stages]}; "
            f"epochs that overlapped a bake (seconds) { {k: round(v, 3) for k, v in overlapped.items()} }, "
            f"median epoch without a bake or stage {out['n1']['alone_median_s']:.3f} s")
        del trainer, bakes, applied, step_grids

        # ---- N3 (run first): a pose-only epoch at P = 3, on the entry's prior SAM stage of epoch 0 ----
        t0 = time.perf_counter()
        p3_dir = os.path.join(root, "p3")
        argv3 = ["--conf", os.path.join(ROOT, M_CONF), "--run_dir", p3_dir, "--device", dev]
        tr3, conf3, _ = cli_train.build_trainer(cli_train.parse_args(argv3))
        tr3.instance_mask_stage(epoch=0)
        tr3.sam_stage(epoch=0)
        tr3.seq._refresh_sam()
        nn1_pose = conf3.model.ray_sampler.max_total_iters + 4  # the sampler's rounds, render, 2 surface, the meshes
        tr3.depth_end, tr3.epoch = False, N_POSE_EPOCH
        window = tr3._pose_window()
        steps3, _, payloads = instrument(tr3)
        counts3, inner3 = [], tr3.builder.step

        def counted3(ts, batch, **kw):
            c0 = read_counts()
            res = inner3(ts, batch, **kw)
            c1 = read_counts()
            counts3.append({k: c1[k] - c0[k] for k in c1})
            return res

        tr3.builder.step = counted3
        before = {k: p.detach().clone() for k, p in tr3.ts.params().items()}
        tr3.train_epoch()
        torch.cuda.synchronize()
        moved = {k for k, p in tr3.ts.params().items() if not torch.equal(p.detach(), before[k])}
        body = {k for k in before if k.startswith("body.")}
        problems += [msg for ok, msg in [
            (window and tr3.seq._sam_masks is not None, f"N3: pose window {window}, SAM masks picked up"),
            ([s[1] for s in steps3] == [MODE_POSE_ONLY] * len(tr3.seq), f"N3: modes {[s[1] for s in steps3]}"),
            (all(math.isfinite(s[3]) and not s[4] for s in steps3), f"N3: losses {steps3}"),
            (moved == body, f"N3: moved {sorted(moved)}, the body leaves {sorted(body)}"),
            (all(p == (True, True, True) for p in payloads), f"N3: pose-loss payloads {payloads}"),
            (all(c == {"nn1": nn1_pose, "grid_trilinear": 1} for c in counts3), f"N3: launches a step {counts3}"),
        ] if not ok]
        out["n3"] = {"steps": len(steps3), "launches": counts3, "losses": [s[3] for s in steps3],
                     "payloads": payloads}
        phase_s["N3"] = time.perf_counter() - t0
        log(f"path N3 (a pose-only epoch on synthetic_p3.yaml, epoch {N_POSE_EPOCH}, depth_end off): {len(steps3)} "
            f"steps, losses {[round(s[3], 5) for s in steps3]}, launches a step {counts3[0] if counts3 else None}, "
            f"moved: every body leaf ({len(body)}) and no net leaf: {moved == body}; {phase_s['N3']:.1f} s")

        # ---- N2: SAM's network at P = 3, on the instance masks of N3's set-up ----
        t0 = time.perf_counter()
        stage_dir = os.path.join(p3_dir, "stage_instance_mask", "00000")
        inst = np.load(os.path.join(stage_dir, "all_person_smpl_mask.npy"))
        kps = np.load(os.path.join(stage_dir, "2d_keypoint.npy"))
        longest = max(len(pr["points"]) for f in range(len(inst))
                      for pr in build_sam_prompts(inst[f], kps[f], np.random.default_rng(0)))
        gen = torch.Generator(dev).manual_seed(SEED + 70)
        model = sam_model.random_sam(SAM_VARIANT, gen, device=dev)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("pos_embed", "rel_pos_h", "rel_pos_w")):
                    p.normal_(0.0, 0.02, generator=gen)
        images = cli_train.frame_images(tr3.seq)
        t1 = time.perf_counter()
        logits = SamSegmenter(sam_model.SamPredictor(model), images)(0, run_dir=p3_dir)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        cpu_dir = os.path.join(root, "p3_cpu")
        os.makedirs(os.path.join(cpu_dir, "stage_instance_mask", "00000"))
        np.save(os.path.join(cpu_dir, "stage_instance_mask", "00000", "all_person_smpl_mask.npy"), inst[:1])
        np.save(os.path.join(cpu_dir, "stage_instance_mask", "00000", "2d_keypoint.npy"), kps[:1])
        model = model.cpu()
        t1 = time.perf_counter()
        cpu = SamSegmenter(sam_model.SamPredictor(model), images[:1])(0, run_dir=cpu_dir)
        cpu_s = time.perf_counter() - t1
        del model
        torch.cuda.empty_cache()
        scale = float(np.abs(cpu).max())
        err = float(np.abs(logits[:1] - cpu).max())
        flips = int((((logits[:1] > 0) != (cpu > 0)) & (np.abs(cpu) > err)).sum())
        iou_card = sam_iou_certainty(logits[:1], os.path.join(cpu_dir, "stage_instance_mask", "00000",
                                                              "all_person_smpl_mask.npy"), 0.5)[0]
        iou_cpu = sam_iou_certainty(cpu, os.path.join(cpu_dir, "stage_instance_mask", "00000",
                                                      "all_person_smpl_mask.npy"), 0.5)[0]
        certainty = sam_iou_certainty(logits, os.path.join(stage_dir, "all_person_smpl_mask.npy"), 0.5)
        problems += [msg for ok, msg in [
            (logits.shape == (len(inst), 3, *inst.shape[-2:]) and np.isfinite(logits).all(),
             f"N2: SAM logits {logits.shape}"),
            (longest + 2 > sam_model.MAX_POINTS, f"N2: the longest prompt has {longest} points, not past 64"),
            (err <= SAM_F64_TOL * max(scale, 1.0), f"N2: card against CPU {err} over max |logit| {scale}"),
            (flips == 0 and np.array_equal(iou_card, iou_cpu), f"N2: {flips} mask pixels flip, IoU {iou_card} | {iou_cpu}"),
        ] if not ok]
        out["n2"] = {"card_s": card_s, "cpu_s": cpu_s, "err": err, "scale": scale, "longest": longest,
                     "iou": certainty[0].tolist() if certainty else None}
        phase_s["N2"] = time.perf_counter() - t0
        log(f"path N2 (SamSegmenter, {SAM_VARIANT} at random weights, synthetic_p3.yaml's {len(inst)} frames, "
            f"P=3): the stage {card_s:.2f} s on the card, its first frame {cpu_s:.1f} s on the CPU; longest prompt "
            f"{longest} points + box (padded to {sam_model.MAX_POINTS}); logits card against CPU max |gap| {err:.3g} "
            f"(max |logit| {scale:.3g}, tolerance {SAM_F64_TOL} of it), {flips} mask pixels flip; frame 0's IoU "
            f"with the instance masks {iou_card.tolist()} | {iou_cpu.tolist()}; certainty over the frames "
            f"{out['n2']['iou']}")
        del tr3

        # ---- N4: edge sampling, a full-width delayed-pose step on path P's directory ----
        t0 = time.perf_counter()
        p_root = os.path.join(ROOT, "outputs", "chip_smoke_path_p")
        p_run = os.path.join(p_root, "run")
        sets = ("dataset.train.end_frame=2", "model.num_training_frames=2",
                f"smpl_model_path={os.path.join(p_root, 'smpl_model')}", f"model.smpl_init_steps={PREP_SMPL_INIT_STEPS}",
                f"model.smpl_init_cache_dir={p_run}")
        argv4 = ["--conf", os.path.join(ROOT, PREP_CONF), "--data_root", os.path.join(p_root, "data"), "--run_dir",
                 os.path.join(root, "edge"), "--device", dev, *(f"--set={s}" for s in sets)]
        tr4, _, _ = cli_train.build_trainer(cli_train.parse_args(argv4))
        tr4.seq.edge_sampling_on = True
        item = tr4.seq.get_train_item(0, np.random.default_rng(SEED))
        batch = tr4.make_batch(item, MODE_DELAYED_POSE)
        c0 = read_counts()
        _, logs4 = tr4.train_step(batch)
        torch.cuda.synchronize()
        c1 = read_counts()
        loss4 = float(logs4["loss"])
        problems += [msg for ok, msg in [
            ("edge_uv" in item and np.array_equal(batch.uv.cpu().numpy(), item["edge_uv"]),
             "N4: the step did not take the edge-sampled rays"),
            (math.isfinite(loss4) and not logs4["update_skipped"], f"N4: loss {loss4}, skipped {logs4['update_skipped']}"),
        ] if not ok]
        out["n4"] = {"loss": loss4, "launches": {k: c1[k] - c0[k] for k in c1}, "rays": int(batch.uv.shape[0])}
        phase_s["N4"] = time.perf_counter() - t0
        log(f"path N4 (edge sampling on path P's directory, {batch.uv.shape[0]} rays of {item['img_size'] if 'img_size' in item else 'the frame'}): "
            f"a delayed-pose step on the edge rays, loss {loss4:.5f}, launches {out['n4']['launches']}; {phase_s['N4']:.1f} s")
        del tr4
    finally:
        unhold()
    launches = read_counts()
    problems += [f"a kernel disagrees with its plain version: {f}" for f in failures]
    held_err = {k: max((e for key, e in held.items() if key[0] == k), default=None) for k in ("nn1", "grid_trilinear")}
    problems += [f"path N held no call of {k}" for k, e in held_err.items() if e is None]
    seconds = time.perf_counter() - t_path
    log(f"path N: launches {launches}; each kernel held to its plain version on the first call of each shape, max abs "
        f"error by shape { {' '.join(map(str, k)): float(f'{e:.3g}') for k, e in held.items()} }; seconds by phase "
        f"{ {k: round(v, 1) for k, v in phase_s.items()} }, whole path {seconds:.1f} s")
    torch.cuda.empty_cache()
    assert not problems, f"path N: {problems}"
    return {**out, "launches": launches, "held": held, "held_err": held_err, "phase_s": phase_s, "seconds": seconds,
            "steps": out["n1"]["steps"] + out["n3"]["steps"] + 1}


def _select_counts(steps):
    """Steps by mode, from `instrument`'s records."""
    return {mode: sum(1 for s in steps if s[1] == mode) for mode in sorted({s[1] for s in steps})}


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

    t_script = time.perf_counter()
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    # ---------------- 2. build ----------------
    from multiply_tpu_torch import native
    from multiply_tpu_torch.utils import jpeg

    libs = (*cuda_build.KERNELS, *cuda_build.VARIANTS)
    build_s, build_logs = cuda_build.build_all(libs)
    t0 = time.perf_counter()
    native._lib()  # the host C++ of path T
    t1 = time.perf_counter()
    jpeg._lib()  # the host JPEG decoder of path V
    log(f"build: {build_s:.1f} s for {', '.join(libs)}; native host library {cuda_build.BUILD_DIR}/libmultiply_host.so "
        f"{t1 - t0:.1f} s; JPEG decoder libjpeg_decode.so {time.perf_counter() - t1:.1f} s")
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
        # the per-point form's yardsticks: its plain version, and grid_sample alone
        t_b1_plain = cuda_time_ms(lambda: grid_cuda.grid_trilinear_plain(*grid_args))
        t_b1_lib = cuda_time_ms(lambda: F.grid_sample(vol, unit.flip(-1)[:, None, None], mode="bilinear",
                                                      padding_mode="border", align_corners=True))
        by_persons = kernels_by_persons(q, verts, grid_args, S)
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

    # ---------------- 7. path O: pose-only steps with the mesh losses ----------------
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
    for i, (name, updates, groups, loss_kw, terms, epoch) in enumerate(VARIANTS):
        torch.cuda.empty_cache()
        run_variant(name, model_conf_with(conf, **updates), groups, scene, state, dev, SEED + 10 + i, loss_kw=loss_kw,
                    terms=terms, epoch=epoch)

    # ---------------- 9. path T: the trainer ----------------
    torch.cuda.empty_cache()
    path_t = run_path_t()

    # ---------------- 10. path S: the SAM refinement path ----------------
    path_s = run_path_s()

    # ---------------- 11. path P: preprocessing, then the entries on its directory ----------------
    torch.cuda.empty_cache()
    path_p = run_path_p()

    # ---------------- 12. path V: ViTPose and JPEG frames ----------------
    torch.cuda.empty_cache()
    path_v = run_path_v(path_p["smpl_dir"])

    # ---------------- 13. --profile on path T's configuration ----------------
    t0 = time.perf_counter()
    prof = run_profile()
    log(f"--profile {prof['steps']} ({time.perf_counter() - t0:.1f} s with its set-up): {prof['wall_s']:.3f} s "
        f"traced; device time by category:")
    for r in prof["rows"]:
        log(f"  {r['category']:<24} {r['total_ms']:10.3f} ms  x{r['count']:<6d} {r['pct']:5.1f}%")

    # ---------------- 14. path D: several devices ----------------
    torch.cuda.empty_cache()
    path_d = run_path_d()

    # ---------------- 15. path L: the example drivers ----------------
    torch.cuda.empty_cache()
    path_l = run_path_l()

    # ---------------- 16. path M: one person and three persons ----------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    path_m1 = run_path_m1()
    m1_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    path_m2 = run_path_m2()
    path_m_s = time.perf_counter() - t0
    comp = path_m1["composite"]
    log(f"path M: {path_m_s:.1f} s (M1 {m1_s:.1f} s); median step P=3 | P=2 (phase 5) | P=1: "
        f"{path_m1['p3']['median_ms']:.2f} | {parity['median_ms']:.2f} | {path_m1['p1']['median_ms']:.2f} ms, P=3 "
        f"sorted composite {path_m1['p3_sorted']['median_ms']:.2f} ms; the composite alone (forward + backward), "
        f"device ms P=1 | 2 | 3, pairwise: {' | '.join(str(comp[p]['pairwise']['device_ms']) for p in M_COMPOSITE_PERSONS)}, "
        f"sorted: {' | '.join(str(comp[p]['sorted']['device_ms']) for p in M_COMPOSITE_PERSONS)}")

    # ---------------- 17. path N: stage overlap and the configurations that had run only on the CPU ----------------
    torch.cuda.empty_cache()
    path_n = run_path_n()

    launches_by_path = {"parity": launches, "fast": launches_f, "pose": launches_p,
                        "trainer": path_t["launches_a"], "trainer_pose": path_t["launches_b"],
                        "sam": path_s["launches"], "preprocessed": path_p["launches"],
                        "vitpose_jpeg": path_v["launches"], "sharded_rank0": path_d["launches"],
                        "examples": path_l["launches"], "persons_p3": path_m1["launches"]["p3"],
                        "persons_p3_sorted": path_m1["launches"]["p3_sorted"],
                        "persons_p3_pose": path_m1["launches"]["p3_pose"], "persons_p1": path_m1["launches"]["p1"],
                        "persons_program": path_m2["launches"], "overlap_and_cpu_only": path_n["launches"]}
    steps_by_path = {"parity": STEPS, "fast": STEPS_FAST, "pose": STEPS_POSE,
                     "trainer": path_t["steps_a"], "trainer_pose": path_t["steps_b"],
                     "sam": path_s["steps"], "preprocessed": path_p["steps"], "vitpose_jpeg": 0,
                     "sharded_rank0": D_STEPS, "examples": path_l["steps"], **{
                         f"persons_{k}": n for k, n in path_m1["steps"].items()}, "persons_program": path_m2["steps"],
                     "overlap_and_cpu_only": path_n["steps"]}
    # the trainer's counts hold its stages' launches too: per step only for the step paths
    per_step = {path: {k: n / steps_by_path[path] for k, n in launches_by_path[path].items()}
                for path in ("parity", "fast", "pose", "sharded_rank0", "persons_p3", "persons_p3_sorted",
                             "persons_p3_pose", "persons_p1")}
    log(f"kernel launches by path: {launches_by_path} over steps {steps_by_path}")

    kernels = [
        {
            "name": "nn1", "route": "cuda", "source": "multiply_tpu_torch/csrc/nn1.cu",
            "replaces": "multiply_tpu/ops/knn_pallas.py:62 (nn1_pallas / _nn_kernel)",
            # `launches` and `launches_per_step` are the parity path's own pair
            "launches": launches["nn1"], "launches_per_step": per_step["parity"]["nn1"],
            "launches_by_path": {k: v["nn1"] for k, v in launches_by_path.items()}, "steps_by_path": steps_by_path,
            "launches_per_step_by_path": {k: v["nn1"] for k, v in per_step.items()},
            "max_abs_err": max(err_a, err_a3, err_a4, path_t["held_err"]["nn1"], path_p["held_err"]["nn1"],
                               path_d["held_err"]["nn1"], path_l["held_err"]["nn1"], path_m2["held_err"]["nn1"], path_n["held_err"]["nn1"],
                               *(v["nn1"]["max_abs_err"] for v in by_persons.values())),
            "max_err": max(err_a, err_a3, err_a4, path_t["held_err"]["nn1"], path_p["held_err"]["nn1"],
                           path_d["held_err"]["nn1"], path_l["held_err"]["nn1"], path_m2["held_err"]["nn1"], path_n["held_err"]["nn1"],
                           *(v["nn1"]["max_abs_err"] for v in by_persons.values())),
            "path_m": {**{f"p{Pm}": {**v["nn1"], "launches": path_m1["launches"][f"p{Pm}"]["nn1"]}
                          for Pm, v in by_persons.items()},
                       "launches_p3_sorted": path_m1["launches"]["p3_sorted"]["nn1"],
                       "launches_p3_pose": path_m1["launches"]["p3_pose"]["nn1"],
                       "launches_program": path_m2["launches"]["nn1"], "max_abs_err_program": path_m2["held_err"]["nn1"],
                       "shapes_held_program": sum(1 for k in path_m2["held"] if k[0] == "nn1")},
            "max_abs_err_path_t": path_t["held_err"]["nn1"],
            "shapes_held_path_t": sum(1 for k in path_t["held"] if k[0] == "nn1"),
            "max_abs_err_path_p": path_p["held_err"]["nn1"],
            "shapes_held_path_p": sum(1 for k in path_p["held"] if k[0] == "nn1"),
            "path_p": {**path_p["nn1"], "launches": path_p["launches"]["nn1"]},
            "path_d_rank0": {**path_d["nn1"], "launches": path_d["launches"]["nn1"],
                             "max_abs_err": path_d["held_err"]["nn1"]},
            "path_l": {**path_l["nn1"], "launches": path_l["launches"]["nn1"],
                       "launches_l2": path_l["launches_l2"]["nn1"], "max_abs_err": path_l["held_err"]["nn1"],
                       "shapes_held": sum(1 for k in path_l["held"] if k[0] == "nn1")},
            "path_n": {"launches": path_n["launches"]["nn1"], "max_abs_err": path_n["held_err"]["nn1"],
                       "shapes_held": sum(1 for k in path_n["held"] if k[0] == "nn1")},
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
            "max_abs_err": max(err_b, err_b1, path_t["held_err"]["grid_trilinear"],
                               path_p["held_err"]["grid_trilinear"], path_d["held_err"]["grid_trilinear"],
                               path_l["held_err"]["grid_trilinear"], path_m2["held_err"]["grid_trilinear"], path_n["held_err"]["grid_trilinear"],
                               *(v["grid_trilinear"]["max_abs_err"] for v in by_persons.values())),
            "max_err": max(err_b, err_b1, path_t["held_err"]["grid_trilinear"], path_p["held_err"]["grid_trilinear"],
                           path_d["held_err"]["grid_trilinear"], path_l["held_err"]["grid_trilinear"],
                           path_m2["held_err"]["grid_trilinear"], path_n["held_err"]["grid_trilinear"],
                           *(v["grid_trilinear"]["max_abs_err"] for v in by_persons.values())),
            "path_m": {**{f"p{Pm}": {**v["grid_trilinear"], "launches": path_m1["launches"][f"p{Pm}"]["grid_trilinear"]}
                          for Pm, v in by_persons.items()},
                       "launches_p3_sorted": path_m1["launches"]["p3_sorted"]["grid_trilinear"],
                       "launches_p3_pose": path_m1["launches"]["p3_pose"]["grid_trilinear"],
                       "launches_program": path_m2["launches"]["grid_trilinear"],
                       "max_abs_err_program": path_m2["held_err"]["grid_trilinear"],
                       "shapes_held_program": sum(1 for k in path_m2["held"] if k[0] == "grid_trilinear")},
            "max_abs_err_path_t": path_t["held_err"]["grid_trilinear"],
            "shapes_held_path_t": sum(1 for k in path_t["held"] if k[0] == "grid_trilinear"),
            "max_abs_err_path_p": path_p["held_err"]["grid_trilinear"],
            "shapes_held_path_p": sum(1 for k in path_p["held"] if k[0] == "grid_trilinear"),
            "path_p": {**path_p["grid"], "launches": path_p["launches"]["grid_trilinear"]},
            "path_d_rank0": {**path_d["grid"], "launches": path_d["launches"]["grid_trilinear"],
                             "max_abs_err": path_d["held_err"]["grid_trilinear"]},
            "path_l": {**path_l["grid"], "launches": path_l["launches"]["grid_trilinear"],
                       "launches_l2": path_l["launches_l2"]["grid_trilinear"],
                       "max_abs_err": path_l["held_err"]["grid_trilinear"],
                       "shapes_held": sum(1 for k in path_l["held"] if k[0] == "grid_trilinear")},
            "path_n": {"launches": path_n["launches"]["grid_trilinear"],
                       "max_abs_err": path_n["held_err"]["grid_trilinear"],
                       "shapes_held": sum(1 for k in path_n["held"] if k[0] == "grid_trilinear")},
            "ms": t_b, "kernel_ms": t_b,
            "plain_ms": t_b_plain, "bound_ms": bound_b,
            "bound_by": "operations" if b_ops / PEAK_FP32_FLOPS > b_bytes / PEAK_BYTES else "bytes",
            "library_ms": t_b_lib, "device_ms": dev_b, "host_us": host_b, "host_us_best": host_b_best,
            "shape": f"P={P} N={n_render} res={res} group={S}",
            "ms_group1": t_b1, "device_ms_group1": dev_b1, "plain_ms_group1": t_b1_plain,
            "library_ms_group1": t_b1_lib, "bound_ms_group1": max(
                GRID_OPS_PER_POINT * P * n_render / PEAK_FP32_FLOPS,
                P * (n_render * 16 + res**3 * 4 + 24) / PEAK_BYTES) * 1e3,
        },
    ]
    log(f"chip_smoke: whole run {time.perf_counter() - t_script:.1f} s after the CUDA check ({smi})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
