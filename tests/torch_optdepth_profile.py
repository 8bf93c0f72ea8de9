"""Time and profile the port's opt_depth on the card, at the long-run driver's
configuration (`multiply_tpu_torch/examples/longrun_synthetic.py`, corrupted
start, colour segmenter), with the ray chunks of `ops/mesh_ops.py`'s
`ray_mesh_intersect` as they are on a GPU and at 256 rays, as they were.

    python tests/torch_optdepth_profile.py [--out DIR] [--its 10]

Trains 2 epochs (so that SAM masks exist), then runs `_opt_depth_frame` on
frame 0 for `--its` iterations (silhouette weight 0.01, as the opt_depth demo)
once per variant, in the order A B B A: the wall seconds and peak memory of
each. Then one profiled frame of the current variant: the device time by
kernel and the kernel launches an iteration. Card only; prints the card's name
and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "outputs", "optdepth_profile"))
    ap.add_argument("--its", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from multiply_tpu_torch import cuda_build, native
    from multiply_tpu_torch.engine import pose_losses, trainer
    from multiply_tpu_torch.examples import longrun_synthetic
    from multiply_tpu_torch.ops import mesh_ops

    cuda_build.build_all(cuda_build.KERNELS)
    native._lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)

    intersect = mesh_ops.ray_mesh_intersect

    def variant(old: bool):
        """The pose losses' ray chunks as they were (256 rays) or as they are."""
        pose_losses.ray_mesh_intersect = (lambda *a, **k: intersect(*a, **{"chunk_size": 256, **k})) if old else intersect

    frame = trainer.Trainer._opt_depth_frame

    def opt_depth(self):
        self.silhouette_weight = 0.01
        self.it_per_loop = args.its
        for name, old in (("as it was", True), ("as it is", False), ("as it is", False), ("as it was", True)):
            variant(old)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            frame(self, 0)
            torch.cuda.synchronize()
            print(f"opt_depth frame 0, {args.its} iterations, ray chunks {name}: "
                  f"{time.perf_counter() - t0:.3f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({smi})",
                  flush=True)
        variant(False)
        from torch.profiler import ProfilerActivity, profile

        self.it_per_loop = 4
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            frame(self, 0)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        print(ka.table(sort_by="cuda_time_total", row_limit=20, max_name_column_width=70))
        launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
        print(f"profiled frame, 4 iterations (2 with depth-map dumps): {launches} kernel launches, "
              f"{sum(e.self_device_time_total for e in ka) / 1e3:.1f} ms device time", flush=True)

    trainer.Trainer.opt_depth = opt_depth
    la = longrun_synthetic.parse_args(["--epochs", "2", "--segment", "2", "--corrupt_masks", "--pose_noise", "0.05",
                                       "--segmenter", "color", "--run_dir", os.path.join(args.out, "run"),
                                       "--out", os.path.join(args.out, "RUNLOG.md")])
    longrun_synthetic.run(longrun_synthetic.build_conf(la), la)


if __name__ == "__main__":
    main()
