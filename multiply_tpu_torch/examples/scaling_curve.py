"""Sharded-step scaling curve: one fixed global ray batch over 1/2/4/8 ranks.

Counterpart of `examples/scaling_curve.py`. The same small training program
(the JAX package's `__graft_entry__._build(full_scale=False)`: 2 persons, 2
frames of 32x40, grid res 16) is stepped by `parallel.sharded_train_step`
with the whole batch's rays split over the ranks. It catches what sharding
can introduce silently: extra collectives, ray batches that do not divide,
and pathological slow-downs. Each row times the identical global batch and
counts the collectives (`RayGroup.all_reduce_sum`, `broadcast`,
`all_gather` calls) one step issues on each rank.

    python -m multiply_tpu_torch.examples.scaling_curve [--rays 256] [--iters 10] [--device cuda]

With `--device cpu` every world size runs as gloo ranks on the CPU. On
`cuda`, a world size up to the visible card count gets a card a rank over
NCCL; a larger one runs as gloo ranks that share cuda:0, whose times are the
card time-sliced between processes, not a scaling figure.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import Config
from . import OUT_DIR

COLLECTIVES = ("all_reduce_sum", "broadcast", "all_gather")
PROGRAM_CONF = Config(
    {
        "dim_frame_encoding": 32,
        "implicit_network": {
            "feature_vector_size": 256, "d_in": 3, "d_out": 1,
            "dims": [64] * 4, "init": "geometry", "bias": 0.6,
            "skip_in": [2], "weight_norm": True,
            "multires": 6, "cond": "smpl", "scene_bounding_sphere": 3.0,
        },
        "rendering_network": {
            "feature_vector_size": 256, "mode": "pose_no_view", "d_in": 14,
            "d_out": 3, "dims": [64, 64], "weight_norm": True, "multires_view": -1,
        },
        "bg_implicit_network": {
            "feature_vector_size": 256, "d_in": 4, "d_out": 1,
            "dims": [64] * 4, "init": "none", "bias": 0.0,
            "skip_in": [], "weight_norm": False,
            "multires": 10, "cond": "frame",
        },
        "bg_rendering_network": {
            "feature_vector_size": 256, "mode": "nerf_frame_encoding",
            "d_in": 3, "d_out": 3, "dims": [128], "weight_norm": False,
            "multires_view": 4,
        },
        "density": {"params_init": {"beta": 0.1}, "beta_min": 1e-4},
        "ray_sampler": {"near": 0.0, "eps": 0.1, "add_tiny": 1e-6, "N_samples": 16, "N_samples_eval": 32,
                        "N_samples_extra": 8, "beta_iters": 5, "max_total_iters": 3,
                        "N_samples_inverse_sphere": 8},
        "sampler_bf16": False,
        "composite_matmul": True,
        "loss": {"smpl_surface_weight": 0.0},
    }
)


def build_program(rays: int, device, num_frames: int = 2, seed: int = 0):
    """(builder, train state, batch) of the small program, the same on every
    rank that calls it with the same seed."""
    from ..body.params import BodyParamTable
    from ..data.synthetic import make_scene, sample_rays
    from ..engine.train import Batch, TrainStep
    from ..models.loss import LossConfig
    from ..models.renderer import MultiplyRenderer

    scene = make_scene(num_frames=num_frames, num_persons=2, height=32, width=40, device=device)
    renderer = MultiplyRenderer(PROGRAM_CONF, num_persons=2, num_frames=num_frames,
                                generator=torch.Generator(device).manual_seed(seed), device=device)
    state = renderer.build_person_state(scene.servers, grid_res=16)
    builder = TrainStep(renderer, state, LossConfig(sam_start_epoch=0))
    tables = [
        BodyParamTable.create(
            num_frames, betas=scene.betas[p], global_orient=scene.poses[:, p, :3],
            transl=scene.transl[:, p], body_pose=scene.poses[:, p, 3:], device=device,
        )
        for p in range(2)
    ]
    ts = builder.init_state(BodyParamTable.stack(tables))

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    r = sample_rays(scene, 0, rays, np.random.default_rng(seed))
    batch = Batch(uv=t(r["uv"]), rgb=t(r["rgb"]), pose=t(scene.cam_pose[0]), intrinsics=t(scene.intrinsics),
                  frame_idx=0, smpl_scale=t(scene.scale), sam_mask=t(r["sam"]))
    return builder, ts, batch


def rank_curve(group, rays: int, iters: int, seed: int = 0) -> dict | None:
    """One rank of one world size: a first step, then `iters` timed steps on
    the whole batch's share. Counts this rank's collectives in each step by
    wrapping the group's methods; rank 0 returns the seconds, the losses and
    every rank's counts (gathered after the timed steps)."""
    from ..parallel import replicate, sharded_train_step

    builder, ts, batch = build_program(rays, group.device, seed=seed)
    replicate([ts.params(), ts.opt_joint, ts.opt_pose], group)
    counts = dict.fromkeys(COLLECTIVES, 0)
    originals = {name: getattr(group, name) for name in COLLECTIVES}

    def counted(name):
        def call(*args):
            counts[name] += 1
            return originals[name](*args)

        return call

    for name in COLLECTIVES:
        setattr(group, name, counted(name))
    try:
        step = sharded_train_step(builder, group)
        gen = torch.Generator(group.device).manual_seed(seed)  # the same whole-batch noise on every rank
        per_step, losses = [], []

        def one_step(ts):
            before = sum(counts.values())
            ts, logs = step(ts, batch, noise=builder.draw_noise(batch, None, gen))
            per_step.append(sum(counts.values()) - before)
            losses.append(float(logs["loss"]))  # waits for the step
            return ts

        t0 = time.perf_counter()
        ts = one_step(ts)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            ts = one_step(ts)
        step_s = (time.perf_counter() - t0) / iters
        by_kind = dict(counts)
    finally:
        for name, fn in originals.items():
            setattr(group, name, fn)
    mine = torch.tensor(per_step, dtype=torch.int64, device=group.device)
    every = group.all_gather(mine).reshape(group.world, -1).cpu().tolist()
    if group.rank != 0:
        return None
    return {"first_s": first_s, "step_s": step_s, "losses": losses, "collectives_by_rank": every,
            "collectives_by_kind": by_kind}


def world_devices(device: str, n: int) -> tuple[list, str, str]:
    """(device of each of n ranks, backend, how the row ran)."""
    if torch.device(device).type != "cuda":
        return [device] * n, "gloo", f"gloo, {n} CPU ranks"
    if n <= torch.cuda.device_count():
        return [f"cuda:{r}" for r in range(n)], "nccl", f"nccl, {n} cards"
    return ["cuda:0"] * n, "gloo", f"gloo, {n} ranks sharing cuda:0"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--worlds", default="1,2,4,8", help="comma-separated world sizes")
    ap.add_argument("--run_dir", default=os.path.join(OUT_DIR, "scaling"), help="holds the rendezvous file")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Print the curve as the JAX driver does; returns its rows."""
    from ..parallel import launch

    args = parse_args(argv)
    worlds = [int(w) for w in args.worlds.split(",")]
    print(f"{'devices':>8} {'first_s':>10} {'step_ms':>9} {'steps/s':>8} {'collectives':>12}  ranks")
    rows = []
    for n in worlds:
        devices, backend, how = world_devices(args.device, n)
        out = launch(rank_curve, (args.rays, args.iters), devices, backend,
                     os.path.join(args.run_dir, ".rendezvous"), timeout_s=600.0)
        if not np.isfinite(out["losses"]).all():
            raise FloatingPointError(f"world {n}: non-finite losses {out['losses']}")
        flat = [c for rank in out["collectives_by_rank"] for c in rank]
        ncoll = flat[0] if len(set(flat)) == 1 else flat
        dt = out["step_s"]
        rows.append({"world": n, "how": how, **out, "collectives": ncoll})
        print(f"{n:>8} {out['first_s']:>10.1f} {dt*1e3:>9.1f} {1.0/dt:>8.2f} {str(ncoll):>12}  {how}")

    # the global batch is fixed: more ranks must not *increase* step time
    # much (ranks that share cores or a card are checked only for
    # pathological blowups)
    t1, tn = rows[0]["step_s"] * 1e3, rows[-1]["step_s"] * 1e3
    print(f"\n{rows[0]['world']}-rank {t1:.1f} ms vs {rows[-1]['world']}-rank {tn:.1f} ms "
          f"({'OK' if tn < 3.0 * t1 else 'PATHOLOGICAL'})")
    return rows


if __name__ == "__main__":
    main()
