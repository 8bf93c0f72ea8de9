"""Sweep the tunable constants of the hand-written kernels on the card.

    python3 -m multiply_tpu_torch.kernel_sweep

For each kernel it rewrites the `constexpr int NAME = value;` lines of the
source in `csrc/`, builds all variants at once into `_build/sweep/`, holds each
against the kernel's plain version and prints its device time (from a
`torch.profiler` trace) at the training step's shapes. Last it prints where the
host time of a wrapper call goes. Needs one NVIDIA GPU; `csrc/` is only read.
The constants in `csrc/` are the ones this sweep found best on an H100.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

import torch

from . import cuda_build
from .ops import grid_cuda, knn_cuda

SWEEP_DIR = os.path.join(cuda_build.BUILD_DIR, "sweep")
# (QUERIES, THREADS, GROUP) of csrc/nn1.cu and (WARPS, PER_LANE) of csrc/grid_trilinear.cu
NN1_VARIANTS = [(4, 128, 8), (4, 128, 4), (4, 128, 16), (2, 128, 8), (1, 128, 8), (8, 128, 8),
                (4, 64, 8), (4, 256, 8)]
GRID_VARIANTS = [(8, 4), (8, 2), (8, 1), (4, 4), (2, 4)]


def with_constants(source: str, **values: int) -> str:
    for name, value in values.items():
        source, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", source)
        if n != 1:
            raise ValueError(f"no single `constexpr int {name}` in the source")
    return source


def start_build(tag: str, source: str, flags=()) -> tuple[subprocess.Popen, str]:
    os.makedirs(SWEEP_DIR, exist_ok=True)
    path, lib = os.path.join(SWEEP_DIR, f"{tag}.cu"), os.path.join(SWEEP_DIR, f"lib{tag}.so")
    with open(path, "w") as f:
        f.write(source)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", lib, path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def finish_build(tag, proc, lib, function, argtypes):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {tag}:\n{log}")
    fn = getattr(ctypes.CDLL(lib), function)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    registers = next((m.group(1) for m in re.finditer(r"Used (\d+) registers", log)), "?")
    return fn, registers


def device_us(fn, kernel_substr: str, reps: int = 50) -> float:
    """Mean device time, in microseconds, of the kernels named *kernel_substr* over `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel_substr in e.key) / reps


def host_us(fn, calls: int = 2000) -> float:
    """Fastest of three means of the host clock around `calls` calls, in microseconds."""
    fn()
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def sweep_nn1(dev, gen) -> None:
    source = open(os.path.join(cuda_build.CSRC_DIR, "nn1.cu")).read()
    q = torch.randn((2, 65536, 3), generator=gen, device=dev) * 0.5
    refs = torch.randn((2, 386, 3), generator=gen, device=dev) * 0.4
    refs[:, 77] = refs[:, 13]  # an exact tie
    cases = {"V=386": (q, refs), "V=6890": (q[0].contiguous(), torch.randn((6890, 3), generator=gen, device=dev) * 0.4),
             "V=4": (q, refs[:, :4].contiguous())}  # V=4: what a launch costs before any scan
    plain = {k: knn_cuda.nn1_plain(*v) for k, v in cases.items()}
    builds = {}
    for qs, threads, group in NN1_VARIANTS:
        text = with_constants(source, QUERIES=qs, THREADS=threads, GROUP=group)
        for exact in (False, True):
            tag = f"nn1_q{qs}_t{threads}_g{group}" + ("_exact" if exact else "")
            builds[tag] = start_build(tag, text, ("-DNN1_EXACT_ROUNDING",) if exact else ())
    stream = cuda_build.current_stream(dev)
    print("nn1: device us at P=2 N=65536 V=386 | N=65536 V=6890 | P=2 N=65536 V=4")
    for tag, (proc, lib) in builds.items():
        fn, registers = finish_build(tag, proc, lib, "nn1_launch", knn_cuda._ARGTYPES)
        times = []
        for name, (qq, rr) in cases.items():
            d2 = torch.empty(qq.shape[:-1], device=dev)
            idx = torch.empty(qq.shape[:-1], dtype=torch.int64, device=dev)
            persons = qq.shape[0] if qq.dim() == 3 else 1

            def call():
                return fn(qq.data_ptr(), rr.data_ptr(), d2.data_ptr(), idx.data_ptr(), persons,
                          qq.shape[-2], rr.shape[-2], stream)

            cuda_build.check(call(), tag)
            torch.cuda.synchronize()
            d2_p, idx_p = (t[..., 0] for t in plain[name])
            if tag.endswith("_exact"):
                ok = torch.equal(d2, d2_p) and torch.equal(idx, idx_p)
            else:  # index swaps only between near ties: rare
                ok = bool(((d2 - d2_p).abs() <= 1e-6 * d2_p).all()) and (idx == idx_p).float().mean() > 0.9999
            if not ok:
                raise AssertionError(f"variant {tag} disagrees with nn1_plain at {name}")
            times.append(device_us(call, "nn1_kernel"))
        print(f"  {tag:26s} {times[0]:7.2f} | {times[1]:7.2f} | {times[2]:5.2f}   {registers} registers", flush=True)


def sweep_grid(dev, gen) -> None:
    source = open(os.path.join(cuda_build.CSRC_DIR, "grid_trilinear.cu")).read()
    P, res, R, S = 2, 64, 512, 97
    g = torch.randn((P, res, res, res), generator=gen, device=dev)
    o = torch.tensor([[-0.6, -1.1, -0.4]] * P, device=dev)
    sp = torch.full((P, 3), 0.03, device=dev)
    dirs = torch.randn((P, R, 1, 3), generator=gen, device=dev) * 0.15 + torch.tensor([0.0, 0.0, 1.0], device=dev)
    depth = torch.linspace(1.5, 4.5, S, device=dev)[None, None, :, None]
    ray_o = torch.tensor([0.3, -0.2, -3.0], device=dev)
    points = {
        "random": torch.rand((P, R * S, 3), generator=gen, device=dev) * 2.2 - 1.2,
        "rays": (ray_o + depth * torch.nn.functional.normalize(dirs, dim=-1)).reshape(P, R * S, 3).contiguous(),
    }
    builds = {f"grid_w{w}_l{l}": start_build(f"grid_w{w}_l{l}", with_constants(source, WARPS=w, PER_LANE=l))
              for w, l in GRID_VARIANTS}
    stream = cuda_build.current_stream(dev)
    print(f"grid_trilinear: device us at P={P} N={R * S} res={res}, group=1 / group={S}, for random points | points along rays")
    for tag, (proc, lib) in builds.items():
        fn, registers = finish_build(tag, proc, lib, "grid_trilinear_launch", grid_cuda._ARGTYPES)
        cells = []
        for pts in points.values():
            want = grid_cuda.grid_trilinear_plain(g, pts, o, sp)
            for group, expect in ((1, want), (S, want.reshape(P, R, S).min(-1).values)):
                out = torch.empty_like(expect)

                def call():
                    return fn(g.data_ptr(), pts.data_ptr(), o.data_ptr(), sp.data_ptr(), out.data_ptr(),
                              P, R * S, res, group, stream)

                cuda_build.check(call(), tag)
                torch.cuda.synchronize()
                if (out - expect).abs().max().item() > 1e-5:
                    raise AssertionError(f"variant {tag} disagrees with grid_trilinear_plain at group={group}")
                cells.append(device_us(call, "grid_trilinear_kernel"))
        print(f"  {tag:14s} {cells[0]:5.2f} / {cells[1]:5.2f} | {cells[2]:5.2f} / {cells[3]:5.2f}   {registers} registers",
              flush=True)
    d = grid_cuda.grid_trilinear_kernel(g, points["rays"], o, sp)
    print(f"  torch's reshape+min over the per-point values (what the fused form removes): "
          f"{device_us(lambda: d.reshape(P, R, S).min(-1), ''):.2f} us")


def host_breakdown(dev, gen) -> None:
    q = torch.randn((2, 512, 3), generator=gen, device=dev)
    refs = torch.randn((2, 386, 3), generator=gen, device=dev)
    shape = q.shape[:-1] + (1,)
    d2, idx = knn_cuda.nn1_kernel(q, refs)
    launch = cuda_build.launcher("nn1", "nn1_launch", knn_cuda._ARGTYPES)
    stream = cuda_build.current_stream(dev)
    parts = {
        "q.new_empty (f32)": lambda: q.new_empty(shape),
        "torch.empty (i64)": lambda: torch.empty(shape, dtype=torch.int64, device=dev),
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "cuda_build.current_stream(dev)": lambda: cuda_build.current_stream(dev),
        "the C launcher alone": lambda: launch(q.data_ptr(), refs.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                                               2, 512, 386, stream),
        "nn1_kernel, whole wrapper": lambda: knn_cuda.nn1_kernel(q, refs),
        "one PyTorch op for scale, q.add(1)": lambda: q.add(1.0),
    }
    print("host time of one call, us (N=512, so that the card keeps up):")
    for name, fn in parts.items():
        print(f"  {name:44s} {host_us(fn):6.2f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    cuda_build.build_all()
    with torch.no_grad():
        sweep_nn1(dev, gen)
        sweep_grid(dev, gen)
        host_breakdown(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
