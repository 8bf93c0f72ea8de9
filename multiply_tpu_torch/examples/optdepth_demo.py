"""opt_depth recovery demo: perturb translations of a trained model, let the
depth/silhouette pass pull them back.

Counterpart of `examples/optdepth_demo.py`. The long-horizon run starts from
ground-truth translations, so its final opt_depth pass has nothing to fix.
This demo shows the pass doing its actual job (reference
multiply_model.py:230-484): load the long run's `last` checkpoint, corrupt
every person translation with noise, run the translation-only opt_depth loop
against the SAM masks, and report PSNR + translation error before/after.
Appends a section to `--out` and writes `<run_dir>/optdepth_demo.json`.

    python -m multiply_tpu_torch.examples.optdepth_demo [--noise 0.08]
        [--run_dir outputs/torch_examples/longrun] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from . import OUT_DIR
from .longrun_synthetic import CONF


def split_rmse(e, fwd):
    """(view-axis rmse, in-plane rmse) of translation errors `e` (P, F, 3):
    the component along the unit camera axis `fwd` (what depth ordering
    constrains) and the rest (what the silhouette term constrains)."""
    d = e @ fwd
    ip = e - d[..., None] * fwd
    return (float(np.sqrt(np.mean(d**2))),
            float(np.sqrt(np.mean(np.sum(ip**2, -1) / 2))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noise", type=float, default=0.08, help="transl noise (m)")
    ap.add_argument("--run_dir", default=os.path.join(OUT_DIR, "longrun"))
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "RUNLOG.md"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=2,
                    help="optimize only the first N frames (CPU demo budget)")
    ap.add_argument("--silhouette_weight", type=float, default=0.01,
                    help="instance-silhouette term weight; the reference "
                         "ships 0.0 (depth ordering only) — with it on, the "
                         "pass also recovers in-plane placement")
    ap.add_argument("--render_rays", type=int, default=128,
                    help="render-anchor rays per iteration (reference: 512, "
                         "multiply_model.py:335; 128 fits the CPU budget)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    return ap.parse_args(argv)


def build_conf(args):
    """`confs/synthetic_base.yaml` with the JAX demo's overrides."""
    from ..config import load_config

    return load_config(
        CONF,
        overrides={
            "model": {
                "depth_end": False,
                "depth_epoch": [],
                "it_per_loop": 40,
                "cano_grid_res": 24,
                "cano_mesh_res_up": 1,
                "mesh_pad_bucket": 4096,
                "interp_samples": 1024,
                "depth_pixel_samples": 1024,
                "depth_render_rays": args.render_rays,
                "loss": {"sam_start_epoch": 40},
            },
            "dataset": {"train": {"num_sample": 128, "end_frame": 4,
                                  "height": 48, "width": 64}},
        },
    )


def run(conf, args) -> dict:
    """The demo on `conf` (from `build_conf`, which a caller may narrow);
    returns what `optdepth_demo.json` holds plus the split rmse."""
    from ..cli.train import build_servers
    from ..data.synthetic import make_scene
    from ..data.synthetic_sequence import SyntheticSequence
    from ..engine.sam_stage import PriorSegmenter
    from ..engine.trainer import Trainer

    dev = torch.device(args.device)
    train = conf.dataset.train
    scene = make_scene(num_frames=train.end_frame, num_persons=2, height=train.height, width=train.width,
                       device=dev)
    seq = SyntheticSequence(
        scene, num_sample=train.num_sample, using_sam=True, run_dir=args.run_dir,
        ratio_uncertain=0.5,
    )
    servers = build_servers(conf, seq, dev)
    tr = Trainer(conf, seq, servers, run_dir=args.run_dir,
                 segmenter=PriorSegmenter(), device=dev)

    ckpts = sorted(glob.glob(os.path.join(args.run_dir, "checkpoints", "*")))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {args.run_dir}")
    ckpt = next((c for c in ckpts if c.endswith("last")), ckpts[-1])
    tr.load_checkpoint(ckpt)
    print(f"loaded {ckpt} (epoch {tr.epoch})")
    seq._refresh_sam()  # pick up the run's stage_sam_mask outputs
    if seq._sam_masks is None:
        raise FileNotFoundError(f"{args.run_dir} has no SAM-stage masks")

    transl = tr.ts.body.transl
    transl_true = transl.detach().cpu().numpy().copy()  # (P, F, 3)
    rng = np.random.default_rng(args.seed)
    noise = rng.uniform(-args.noise, args.noise, transl_true.shape).astype(np.float32)
    with torch.no_grad():
        transl.copy_(torch.as_tensor(transl_true + noise, device=dev))

    err0 = float(np.abs(noise).max())
    psnr0 = tr.validate(frame_idx=0)
    print(f"perturbed: max |err| {err0*100:.1f} cm, PSNR {psnr0:.2f} dB")

    tr.silhouette_weight = args.silhouette_weight
    n_f = min(args.frames, tr.num_frames)
    t0 = time.time()
    print(f"opt_depth on {n_f} frames (silhouette_weight={args.silhouette_weight})")
    for i in range(n_f):
        tr._opt_depth_frame(i)
    transl_after = tr.ts.body.transl.detach().cpu().numpy()[:, :n_f]
    wall = time.time() - t0

    # score only the optimized frames, split into the camera view axis and
    # the image plane
    fwd = np.asarray(scene.cam_pose[0][:3, 2], np.float32)
    fwd = fwd / np.linalg.norm(fwd)
    tt, nn = transl_true[:, :n_f], noise[:, :n_f]
    err0 = float(np.abs(nn).max())
    err1 = float(np.abs(transl_after - tt).max())
    rmse0 = float(np.sqrt(np.mean(nn**2)))
    rmse1 = float(np.sqrt(np.mean((transl_after - tt) ** 2)))
    d_rmse0, ip_rmse0 = split_rmse(nn, fwd)
    d_rmse1, ip_rmse1 = split_rmse(transl_after - tt, fwd)
    psnr1 = tr.validate(frame_idx=0)
    print(
        f"opt_depth ({wall/60:.1f} min): rmse {rmse0*100:.2f} -> "
        f"{rmse1*100:.2f} cm (view-axis {d_rmse0*100:.2f} -> {d_rmse1*100:.2f}, "
        f"in-plane {ip_rmse0*100:.2f} -> {ip_rmse1*100:.2f}), "
        f"PSNR {psnr0:.2f} -> {psnr1:.2f} dB"
    )

    section = (
        "\n## opt_depth perturbation demo (`multiply_tpu_torch/examples/optdepth_demo.py`)\n\n"
        f"Loaded the epoch-{tr.epoch} checkpoint, corrupted all translations "
        f"with U(-{args.noise}, {args.noise}) m noise, ran the translation-only "
        f"opt_depth pass (depth-order + interpenetration + instance-silhouette "
        f"at weight {args.silhouette_weight}) on {n_f} frames "
        f"({wall/60:.0f} min on {dev}):\n\n"
        "| rmse (cm) | total | view-axis | in-plane | val PSNR (dB) |\n"
        "|---|---|---|---|---|\n"
        f"| perturbed | {rmse0*100:.2f} | {d_rmse0*100:.2f} | {ip_rmse0*100:.2f} | {psnr0:.2f} |\n"
        f"| after opt_depth | {rmse1*100:.2f} | {d_rmse1*100:.2f} | {ip_rmse1*100:.2f} | {psnr1:.2f} |\n\n"
        "At the reference's shipped weights (silhouette 0.0) the pass "
        "constrains depth ordering only: the JAX package's parity run (`RUNLOG.md`) recovered the view-axis "
        "component (total rmse 5.51 -> 4.72 cm) while in-plane error was free "
        "to drift — the silhouette term pins the image-plane placement.\n"
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(section)
    print(f"appended demo section to {args.out}")
    result = {"err0": err0, "err1": err1, "rmse0": rmse0, "rmse1": rmse1,
              "psnr0": psnr0, "psnr1": psnr1, "wall_s": wall}
    with open(os.path.join(args.run_dir, "optdepth_demo.json"), "w") as f:
        json.dump(result, f)
    return {**result, "view_rmse": (d_rmse0, d_rmse1), "in_plane_rmse": (ip_rmse0, ip_rmse1), "frames": n_f}


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(build_conf(args), args)


if __name__ == "__main__":
    main()
