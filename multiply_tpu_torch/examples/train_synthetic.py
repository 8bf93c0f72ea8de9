"""Demo: optimize a 2-person scene from scratch on a synthetic sequence.

Counterpart of `examples/train_synthetic.py`: the framework's minimal end-to-end
flow (per-person SDF fields + SMPL deformation + error-bound sampling +
multi-person compositing + NeRF++ background), with the port's `TrainStep`
stepped directly on a self-contained synthetic scene, then one full frame
rendered and its PSNR.

    python -m multiply_tpu_torch.examples.train_synthetic [--steps 30] [--rays 128] [--out out.png] [--device cuda]

The step noise comes from one `torch.Generator` seeded 0; the rays from
`np.random.default_rng(0)`, as in the JAX driver. There is no compile: the
first step's seconds are the first eager step's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..body.params import BodyParamTable
from ..config import Config
from ..data.synthetic import make_scene, sample_rays
from ..engine.train import Batch, TrainStep
from ..models.loss import LossConfig
from ..models.renderer import MultiplyRenderer, RenderInputs
from ..utils.cameras import pixel_grid
from ..utils.io import write_png

DEMO_CONF = Config(
    {
        "dim_frame_encoding": 16,
        "implicit_network": {
            "feature_vector_size": 64, "d_in": 3, "d_out": 1,
            "dims": [64, 64, 64, 64], "init": "geometry", "bias": 0.6,
            "skip_in": [2], "weight_norm": True, "multires": 4,
            "cond": "smpl", "scene_bounding_sphere": 3.0,
        },
        "rendering_network": {
            "feature_vector_size": 64, "mode": "pose_no_view", "d_in": 14,
            "d_out": 3, "dims": [64, 64], "weight_norm": True, "multires_view": -1,
        },
        "bg_implicit_network": {
            "feature_vector_size": 64, "d_in": 4, "d_out": 1,
            "dims": [64, 64], "init": "none", "bias": 0.0, "skip_in": [],
            "weight_norm": False, "multires": 4, "cond": "frame",
        },
        "bg_rendering_network": {
            "feature_vector_size": 64, "mode": "nerf_frame_encoding",
            "d_in": 3, "d_out": 3, "dims": [32], "weight_norm": False,
            "multires_view": 2,
        },
        "density": {"params_init": {"beta": 0.1}, "beta_min": 1e-4},
        "ray_sampler": {
            "near": 0.0, "N_samples": 16, "N_samples_eval": 32,
            "N_samples_extra": 8, "eps": 0.1, "beta_iters": 5,
            "max_total_iters": 3, "N_samples_inverse_sphere": 8,
            "add_tiny": 1e-6,
        },
        "loss": {"smpl_surface_weight": 0.0},
    }
)
CHUNK = 512  # rays of one full-frame render call


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rays", type=int, default=128)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", type=str, default="", help="GT | prediction PNG (none by default)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, render frame 0 and print as the JAX driver does; returns the
    losses, skipped-update flags, seconds of each step (host clock, up to the
    loss read, which waits for the step) and the PSNR."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    scene = make_scene(num_frames=args.frames, num_persons=2, height=36, width=48, device=dev)
    renderer = MultiplyRenderer(DEMO_CONF, num_persons=2, num_frames=args.frames,
                                generator=torch.Generator(dev).manual_seed(0), device=dev)
    state = renderer.build_person_state(scene.servers, grid_res=24)
    builder = TrainStep(renderer, state, LossConfig(sam_start_epoch=0), learning_rate=3e-3)

    tables = [
        BodyParamTable.create(
            args.frames, betas=scene.betas[p], global_orient=scene.poses[:, p, :3],
            transl=scene.transl[:, p], body_pose=scene.poses[:, p, 3:], device=dev,
        )
        for p in range(2)
    ]
    ts = builder.init_state(BodyParamTable.stack(tables))
    gen = torch.Generator(dev).manual_seed(0)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    rng = np.random.default_rng(0)
    t0 = time.time()
    losses, skipped, step_s = [], [], []
    for i in range(args.steps):
        t_step = time.perf_counter()
        f = i % args.frames
        rays = sample_rays(scene, f, args.rays, rng)
        batch = Batch(uv=t(rays["uv"]), rgb=t(rays["rgb"]), pose=t(scene.cam_pose[f]), intrinsics=t(scene.intrinsics),
                      frame_idx=f, smpl_scale=t(scene.scale), sam_mask=t(rays["sam"]))
        ts, logs = builder.step(ts, batch, generator=gen)
        losses.append(float(logs["loss"]))
        skipped.append(float(logs["update_skipped"]))
        step_s.append(time.perf_counter() - t_step)
        if i == 0:
            print(f"first step (eager, no compile): {time.time()-t0:.1f}s")
        if i % 10 == 0 or i == args.steps - 1:
            print(
                f"step {i:4d} loss={losses[-1]:.4f} rgb={float(logs['rgb_loss']):.4f} "
                f"eik={float(logs['eikonal_loss']):.4f} sam={float(logs['sam_mask_loss']):.4f}"
                f" skipped={int(skipped[-1])}"
            )
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    # render a full validation frame in chunks, with no autograd graph kept
    uv_full = t(pixel_grid(scene.width, scene.height))
    body = ts.body
    rgb, acc = [], []
    with torch.no_grad():
        for chunk in uv_full.split(CHUNK):
            inputs = RenderInputs(
                uv=chunk, pose=t(scene.cam_pose[0]), intrinsics=t(scene.intrinsics), scale=t(scene.scale),
                transl=body.transl[:, 0], thetas=body.thetas(0), betas=body.betas[:, 0], frame_idx=0, epoch=10_000,
            )
            out = renderer.render(state, inputs, train=False)
            rgb.append(out["rgb_values"])
            acc.append(out["acc_map"])
    img = torch.cat(rgb).cpu().numpy()
    acc = torch.cat(acc).cpu().numpy()

    pred = img.reshape(scene.height, scene.width, 3)
    gt = scene.images[0]
    psnr = float(-10 * np.log10(np.mean((pred - gt) ** 2) + 1e-10))
    print(f"full-frame render: PSNR={psnr:.2f} dB, acc range [{acc.min():.3f},{acc.max():.3f}]")

    if args.out:
        side = np.concatenate([gt, pred], axis=1)
        write_png(args.out, (np.clip(side, 0, 1) * 255).astype(np.uint8))
        print(f"wrote {args.out} (GT | prediction)")
    return {"losses": losses, "skipped": skipped, "step_s": step_s, "psnr": psnr, "out": args.out or None}


if __name__ == "__main__":
    main()
