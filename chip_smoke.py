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
     per-ray minimum; `nn1` at V = 386 and 6890 and at N = 512, and its exactly
     rounded build bit for bit), with times of kernel, plain version and a
     PyTorch library yardstick (never called by the port), the wrapper's host
     time, the kernels launched per wrapper call and the card's least time for
     the same work (`bound_ms`);
  5. training: full-width training steps of 512 rays over different frames
     with launch counters zeroed just before; asserts finite losses, no
     skipped update, changed params and the kernels' launch counts; then one
     full frame rendered in 512-ray chunks and its PSNR.
Prints the `{"kernels": [...]}` line, then the nvidia-smi line, then
`{"ok": true, "device": {...}}` as the last line.
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
STEPS = 11  # step 0 warms up; the rest are timed
RAYS = 512
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
NN1_OPS_PER_PAIR = 9  # 3 sub, 3 mul, 2 add, 1 compare
GRID_OPS_PER_POINT = 40  # 3x (sub, div, 2 clamps, floor, sub, min) + 7 lerps x 3
LAUNCHES_BEFORE = 7447  # kernel launches of one step before the kernels' wrappers were thinned


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

    d2_k, idx_k = knn_cuda.nn1_kernel(q, r)
    d2_e, idx_e = knn_cuda.nn1_kernel(q, r, exact=True)
    d2_p, idx_p = knn_cuda.nn1_plain(q, r)
    torch.cuda.synchronize()
    assert d2_k.shape == d2_p.shape and idx_k.shape == idx_p.shape, f"{name}: shapes"
    assert idx_k.dtype == torch.int64 and bool((d2_k >= 0).all()), f"{name}: output form"
    assert torch.equal(d2_e, d2_p) and torch.equal(idx_e, idx_p), f"{name}: exact build differs"
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


def step_breakdown(step_fn, top=10):
    """Profile one call of `step_fn`: (wall ms, device-busy ms, top kernels by device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    ours = [e for e in kernels if "nn1_kernel" in e.key or "grid_trilinear_kernel" in e.key]
    rows = [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in kernels[:top] + ours]
    return wall, busy, rows, len(kernels), sum(e.count for e in kernels)


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
    from multiply_tpu_torch.body.params import BodyParamTable
    from multiply_tpu_torch.config import load_config
    from multiply_tpu_torch.data.synthetic import make_scene, sample_rays
    from multiply_tpu_torch.engine.train import Batch, TrainStep
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
    libs = (*cuda_build.KERNELS, *cuda_build.VARIANTS)
    build_s, build_logs = cuda_build.build_all(libs)
    log(f"build: {build_s:.1f} s for {', '.join(libs)}")
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
    builder = TrainStep(renderer, state, LossConfig(sam_start_epoch=0),
                        learning_rate=conf.learning_rate)
    tables = [
        BodyParamTable.create(
            F_, betas=scene.betas[p], global_orient=scene.poses[:, p, :3],
            transl=scene.transl[:, p], body_pose=scene.poses[:, p, 3:], device=dev,
        )
        for p in range(P)
    ]
    ts = builder.init_state(BodyParamTable.stack(tables))
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
        refs_big = torch.randn((6890, 3), generator=kgen, device=dev) * 0.4
        q_big = torch.randn((n_sampler, 3), generator=kgen, device=dev) * 0.5
        err_a2, nd_a2 = check_nn1(q_big, refs_big, "nn1 V=6890")
        log(f"nn1: max|d2 err| {err_a:.3g} (V=386, {nd_a} tie swaps), {err_a3:.3g} (N={RAYS}, "
            f"{nd_a3} tie swaps), {err_a2:.3g} (V=6890, {nd_a2} tie swaps); exact build bit-identical")

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

    # ---------------- 5. training: the port's main path ----------------
    rng = np.random.default_rng(SEED)
    before = {k: p.detach().clone() for k, p in ts.params().items()}
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.nn1.launches = 0
    grid_cuda.grid_trilinear.launches = 0

    def make_batch(f):
        rays = sample_rays(scene, f, RAYS, rng)
        return Batch(
            uv=torch.as_tensor(rays["uv"], device=dev), rgb=torch.as_tensor(rays["rgb"], device=dev),
            pose=torch.as_tensor(scene.cam_pose[f], device=dev),
            intrinsics=torch.as_tensor(scene.intrinsics, device=dev), frame_idx=f,
            smpl_scale=torch.as_tensor(scene.scale, device=dev),
            sam_mask=torch.as_tensor(rays["sam"], device=dev),
        )

    step_s = []
    for i in range(STEPS):
        f = i % F_
        batch = make_batch(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, logs = builder.step(ts, batch, generator=gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in logs.items()}
        assert all(math.isfinite(v) for v in vals.values()), f"step {i}: non-finite {vals}"
        assert vals["update_skipped"] == 0.0, f"step {i}: update skipped"
        log(f"step {i} frame {f}: loss {vals['loss']:.5f} rgb {vals['rgb_loss']:.5f} "
            f"eik {vals['eikonal_loss']:.5f} {step_s[-1] * 1e3:.1f} ms")
    launches = {"nn1": knn_cuda.nn1.launches, "grid_trilinear": grid_cuda.grid_trilinear.launches}
    peak_mem = torch.cuda.max_memory_allocated()
    assert launches["nn1"] == 8 * STEPS, f"nn1 launched {launches['nn1']} times in {STEPS} steps"
    assert launches["grid_trilinear"] == STEPS, f"grid_trilinear launched {launches['grid_trilinear']} times"
    # every leaf moves except the pose-embedding weight, whose input (the pose
    # conditioning) is zero before epoch 20, so its gradient is exactly zero
    unchanged = {k for k, p in ts.params().items() if torch.equal(p, before[k])}
    assert unchanged <= {"net.fg_render.lin_pose.weight"}, f"params unchanged: {unchanged}"
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    log(f"train: median step {med * 1e3:.2f} ms ({RAYS / med:.1f} rays/s) over steps 1..{STEPS - 1}, "
        f"step 0 {step_s[0] * 1e3:.1f} ms, peak memory {peak_mem / 2**30:.3f} GiB")

    # where one more step's time goes (after the counts were read)
    batch = make_batch(STEPS % F_)
    wall, busy, rows, n_names, n_launch = step_breakdown(lambda: builder.step(ts, batch, generator=gen))
    log(f"profiled step: wall {wall:.2f} ms, device busy {busy:.2f} ms (idle share "
        f"{1 - busy / wall:.3f}), {n_launch} kernel launches of {n_names} kinds ({LAUNCHES_BEFORE} "
        f"before the kernels' wrappers were thinned); top by device time, then the two ported kernels:")
    for name, ms, count in rows:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name}")

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

    kernels = [
        {
            "name": "nn1", "route": "cuda", "source": "multiply_tpu_torch/csrc/nn1.cu",
            "replaces": "multiply_tpu/ops/knn_pallas.py:62 (nn1_pallas / _nn_kernel)",
            "launches": launches["nn1"], "launches_per_step": launches["nn1"] / STEPS,
            "max_abs_err": err_a, "max_err": err_a, "ms": t_a, "kernel_ms": t_a,
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
            "launches": launches["grid_trilinear"], "launches_per_step": launches["grid_trilinear"] / STEPS,
            "max_abs_err": max(err_b, err_b1), "max_err": max(err_b, err_b1), "ms": t_b, "kernel_ms": t_b,
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
