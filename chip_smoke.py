#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: needs CUDA (there is no CPU path); prints the card's name and
     power limit and turns TF32 off for matmuls and cuDNN;
  2. build: compiles both hand-written kernels from `multiply_tpu_torch/csrc`
     (one nvcc per source, in parallel) into `multiply_tpu_torch/_build`;
  3. set-up: the synthetic 2-person scene and the per-person state with the
     canonical SDF grids baked at res 64, at the widths of
     `confs/model/taichi01_model.yaml`, weights random from a seed;
  4. kernels: each kernel against its plain PyTorch version on the card at
     the training step's shapes, with times of kernel, plain version and a
     PyTorch library yardstick (never called by the port) and the card's
     least time for the same work (`bound_ms`);
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
    """Kernel vs plain on one input; returns (max_abs_err, n_idx_mismatch)."""
    import torch

    from multiply_tpu_torch.ops import knn_cuda

    d2_k, idx_k = knn_cuda.nn1_kernel(q, r)
    d2_p, idx_p = knn_cuda.nn1_plain(q, r)
    torch.cuda.synchronize()
    rel = ((d2_k - d2_p).abs() / d2_p.clamp_min(1e-30)).max().item()
    assert rel <= 1e-6, f"{name}: d2 relative error {rel} > 1e-6"
    # a differing index is allowed only where the two candidates tie within 1e-6
    diff = (idx_k != idx_p)[..., 0]
    n_diff = int(diff.sum())
    if n_diff:
        chosen = torch.take_along_dim(r, idx_k.expand(idx_k.shape[:-1] + (3,)), dim=-2)
        d_chosen = ((q - chosen) ** 2).sum(-1)
        gap = (d_chosen - d2_p[..., 0]).abs()[diff]
        assert gap.max().item() <= 1e-6, f"{name}: index differs away from a tie ({gap.max().item()})"
    return (d2_k - d2_p).abs().max().item(), n_diff


def device_time_ms(fn, kernel_substr, reps=20):
    """Mean device time of the kernels whose name holds `kernel_substr`, from a
    torch.profiler trace of `reps` calls (None if the trace has no such kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and kernel_substr in e.key
    )
    return total / reps / 1e3 if total > 0 else None


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
    build_s, build_logs = cuda_build.build_all()
    log(f"build: {build_s:.1f} s for {', '.join(cuda_build.KERNELS)}")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

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
        refs_big = torch.randn((6890, 3), generator=kgen, device=dev) * 0.4
        q_big = torch.randn((n_sampler, 3), generator=kgen, device=dev) * 0.5
        err_a2, nd_a2 = check_nn1(q_big, refs_big, "nn1 V=6890")
        log(f"nn1: max|d2 err| {err_a:.3g} (V=386, {nd_a} tie swaps), {err_a2:.3g} (V=6890, {nd_a2} tie swaps)")

        g = state.cano_grid
        res = g["grid"].shape[-1]
        glo = g["origin"][:, None, :]
        ghi = glo + g["spacing"][:, None, :] * (res - 1)
        pts = glo - 0.1 + (ghi - glo + 0.2) * torch.rand((P, n_render, 3), generator=kgen, device=dev)
        out_k = grid_cuda.grid_trilinear_kernel(g["grid"], pts, g["origin"], g["spacing"])
        out_p = grid_cuda.grid_trilinear_plain(g["grid"], pts, g["origin"], g["spacing"])
        err_b = (out_k - out_p).abs().max().item()
        assert err_b <= 1e-5, f"grid_trilinear: max abs error {err_b} > 1e-5"
        log(f"grid_trilinear: max abs err {err_b:.3g}")

        t_a = cuda_time_ms(lambda: knn_cuda.nn1_kernel(q, verts))
        t_a_plain = cuda_time_ms(lambda: knn_cuda.nn1_plain(q, verts), reps=20)
        t_a_lib = cuda_time_ms(
            lambda: torch.cdist(q, verts, compute_mode="donot_use_mm_for_euclid_dist").min(-1), reps=20
        )
        t_a2 = cuda_time_ms(lambda: knn_cuda.nn1_kernel(q_big, refs_big), reps=20)
        t_a2_plain = cuda_time_ms(lambda: knn_cuda.nn1_plain(q_big, refs_big), reps=20)
        t_b = cuda_time_ms(lambda: grid_cuda.grid_trilinear_kernel(g["grid"], pts, g["origin"], g["spacing"]))
        t_b_plain = cuda_time_ms(lambda: grid_cuda.grid_trilinear_plain(g["grid"], pts, g["origin"], g["spacing"]))
        unit = (pts - glo) / g["spacing"][:, None, :] / (res - 1) * 2 - 1  # align_corners=True coords
        vol = g["grid"][:, None]  # (P, 1, X, Y, Z): grid_sample's (x, y, z) index (Z, Y, X)
        t_b_lib = cuda_time_ms(
            lambda: F.grid_sample(vol, unit.flip(-1)[:, None, None], mode="bilinear",
                                  padding_mode="border", align_corners=True)
        )
        dev_a = device_time_ms(lambda: knn_cuda.nn1_kernel(q, verts), "nn1_kernel")
        dev_b = device_time_ms(
            lambda: grid_cuda.grid_trilinear_kernel(g["grid"], pts, g["origin"], g["spacing"]),
            "grid_trilinear_kernel",
        )
    log(f"device time (profiler): nn1 {dev_a} ms, grid_trilinear {dev_b} ms")

    V = verts.shape[1]
    a_ops = NN1_OPS_PER_PAIR * P * n_sampler * V
    a_bytes = P * (n_sampler * 12 + V * 12 + n_sampler * 8)
    b_bytes = P * (n_render * 12 + res**3 * 4 + 24 + n_render * 4)
    b_ops = GRID_OPS_PER_POINT * P * n_render
    bound_a = max(a_ops / PEAK_FP32_FLOPS, a_bytes / PEAK_BYTES) * 1e3
    bound_b = max(b_ops / PEAK_FP32_FLOPS, b_bytes / PEAK_BYTES) * 1e3
    a2_ops = NN1_OPS_PER_PAIR * n_sampler * 6890
    log(f"nn1 at V=6890, N={n_sampler}: kernel {t_a2:.4f} ms, plain {t_a2_plain:.4f} ms, "
        f"bound {a2_ops / PEAK_FP32_FLOPS * 1e3:.4f} ms (operations)")

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
        f"{1 - busy / wall:.3f}), {n_launch} kernel launches of {n_names} kinds; top by device "
        f"time, then the two ported kernels:")
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
            "library_ms": t_a_lib, "device_ms": dev_a, "shape": f"P={P} N={n_sampler} V={V}",
        },
        {
            "name": "grid_trilinear", "route": "cuda", "source": "multiply_tpu_torch/csrc/grid_trilinear.cu",
            "replaces": "multiply_tpu/ops/grid_pallas.py:80 (_grid_trilinear / _kernel)",
            "launches": launches["grid_trilinear"], "launches_per_step": launches["grid_trilinear"] / STEPS,
            "max_abs_err": err_b, "max_err": err_b, "ms": t_b, "kernel_ms": t_b,
            "plain_ms": t_b_plain, "bound_ms": bound_b,
            "bound_by": "operations" if b_ops / PEAK_FP32_FLOPS > b_bytes / PEAK_BYTES else "bytes",
            "library_ms": t_b_lib, "device_ms": dev_b, "shape": f"P={P} N={n_render} res={res}",
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
