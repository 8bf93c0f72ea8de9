"""Long-horizon orchestrated run: the full MultiPly refinement schedule on the
synthetic scene, scaled ~5x down from the reference's epoch milestones.

Counterpart of `examples/longrun_synthetic.py`. Exercises, on ONE timeline:
  * SAM-loss onset (sam_start_epoch),
  * uncertainty-driven delayed-pose epochs before pose_correction_epoch,
  * pose-opt epochs with the mesh-based depth-order / silhouette /
    interpenetration step losses (pose_start..pose_end, every interval),
  * canonical-mesh refreshes + instance-mask/SAM stages,
  * a final opt_depth translation pass,
and writes a runlog (the JAX driver's markdown, word for word) with its
figures in a folder beside it (PSNR + mask-IoU trajectory).

    python -m multiply_tpu_torch.examples.longrun_synthetic [--epochs 200]
        [--out outputs/torch_examples/RUNLOG.md] [--device cuda]

The corrupted start of the JAX driver's `RUNLOG_CORRUPT.md`:
    python -m multiply_tpu_torch.examples.longrun_synthetic --epochs 180 --corrupt_masks
        --pose_noise 0.05 --segmenter color --out outputs/torch_examples/RUNLOG_CORRUPT.md

The translation noise is the JAX driver's numpy draw; the trainer's step noise
comes from its `torch.Generator`, so a trajectory matches JAX's in its
schedule-driven columns and in band, not number for number. A failed
validation raises. The plot needs matplotlib; without it the runlog is
written with the validation renders alone.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import time

import numpy as np
import torch

from ..data.dataset import dilate_box
from . import OUT_DIR

CONF = os.path.join(os.path.dirname(__file__), "..", "..", "confs", "synthetic_base.yaml")


def corrupt_sam_logits(scene, rng):
    """Corrupt the initial masks the way bad video preprocessing does:
    person 0 dilated ~4 px into background/partner on every frame, and a
    horizontal band swapped between persons 0/1 on every even frame (the
    instance-confusion failure SAM self-refinement exists to fix). The 9-box
    is odd, so `dilate_box` centres it as OpenCV does; `rng` draws nothing."""
    logits = scene.sam_logits.copy()
    F, H, W, P = logits.shape
    for f in range(F):
        m0 = (logits[f, :, :, 0] > 0).astype(np.uint8)
        d0 = dilate_box(m0, 9) > 0
        logits[f, :, :, 0] = np.where(d0, 8.0, -8.0)
        if P >= 2 and f % 2 == 0:
            band = slice(H // 3, 2 * H // 3)
            sw = logits[f, band, :, 0].copy()
            logits[f, band, :, 0] = logits[f, band, :, 1]
            logits[f, band, :, 1] = sw
    return logits


def gt_iou(sam_logits, gt_masks):
    """Mean per-person IoU of binary masks vs ground truth.
    sam_logits (F, H, W, P) logits; gt_masks (F, H, W, P) bool."""
    b = np.asarray(sam_logits) > 0
    gt = np.asarray(gt_masks) > 0.5
    inter = np.logical_and(b, gt).sum(axis=(1, 2))
    union = np.logical_or(b, gt).sum(axis=(1, 2))
    return float((inter / np.maximum(union, 1)).mean())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--segment", type=int, default=20, help="metrics cadence")
    ap.add_argument("--run_dir", default=os.path.join(OUT_DIR, "longrun"))
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "RUNLOG.md"))
    ap.add_argument("--parity", action="store_true",
                    help="strict-f32 sampler (sampler_bf16: false) — the A/B "
                         "complement to the default run on the same schedule")
    ap.add_argument("--bf16", action="store_true",
                    help="sampler_bf16: true — the fast-preset arm of the "
                         "full-schedule A/B (code default is f32)")
    ap.add_argument("--corrupt_masks", action="store_true",
                    help="corrupt the INITIAL per-person masks the way bad "
                         "preprocessing does (dilate person 0, swap a band "
                         "between persons on half the frames) so the "
                         "progressive mask self-refinement loop has real "
                         "errors to correct (multiply_model.py:489-519)")
    ap.add_argument("--pose_noise", type=float, default=0.0,
                    help="U(-x, x) m noise on the trainer's initial "
                         "translations (bad masks come from bad body "
                         "estimates; GT poses would let the SMPL-rendered "
                         "instance masks fix everything in one stage)")
    ap.add_argument("--segmenter", default="prior", choices=["prior", "color"],
                    help="prior = identity refinement (rendered instance "
                         "masks); color = image-driven ColorPromptPredictor "
                         "(prompts from the model, mask from image evidence "
                         "— the SAM mechanism without SAM weights)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    return ap.parse_args(argv)


def build_conf(args):
    """`confs/synthetic_base.yaml` with the JAX driver's schedule overrides."""
    from ..config import load_config

    return load_config(
        CONF,
        overrides={
            "model": {
                # schedule scaled ~5x down from the reference milestones
                "pose_correction_epoch": 100,
                "pose_start_epoch": 60,
                "pose_end_epoch": 160,
                "pose_opt_interval": 10,
                "pose_opt_epoch": 1,
                "depth_end": False,  # pose-opt step-loss mode
                "depth_epoch": [],
                "it_per_loop": 40,
                "cano_grid_res": 24,
                "cano_mesh_res_up": 1,
                "mesh_pad_bucket": 4096,
                "pose_pixel_samples": 1024,
                "interp_samples": 2048,
                "depth_pixel_samples": 2048,
                "loss": {"sam_start_epoch": 40},
                **({"sampler_bf16": False} if args.parity else {}),
                **({"sampler_bf16": True} if args.bf16 else {}),
            },
            "dataset": {"train": {"num_sample": 128, "end_frame": 4,
                                  "height": 48, "width": 64}},
        },
    )


def segment_logs(metrics_path, seg_lo):
    """(last step record, the segment's pose-loss maxima, its most delayed-pose
    steps in an epoch) from `metrics.jsonl`, as the JAX driver reads it."""
    logs = {}
    pose_max = {"pose_depth_order_loss": 0.0, "pose_interpenetration_loss": 0.0}
    n_delayed = 0.0
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            for line in f:
                rec = json.loads(line)
                if "loss" not in rec:
                    continue
                logs = rec
                # pose losses fire only on pose-opt epochs — report the
                # segment max, not whatever the segment's last epoch was
                if rec.get("epoch", -1) >= seg_lo:
                    for k in pose_max:
                        pose_max[k] = max(pose_max[k], rec.get(k, 0.0))
                    n_delayed = max(n_delayed, rec.get("n_delayed_pose", 0.0))
    return logs, pose_max, n_delayed


def run(conf, args, on_segment=None) -> dict:
    """The schedule on `conf` (from `build_conf`, which a caller may narrow).
    `on_segment(trainer, row)`, if given, is called after each segment's row.
    Returns the rows, the initial mask IoU and translation error, the final
    opt_depth pass's PSNR before/after, its largest translation change and
    seconds, the wall time, and `segments`: for each segment and then the
    final pass, the peak device memory in GiB (None on the CPU) and the
    launches of the port's two kernels."""
    from ..cli.train import build_servers
    from ..data.synthetic import make_scene
    from ..data.synthetic_sequence import SyntheticSequence
    from ..engine.sam_stage import ColorPromptPredictor, PriorSegmenter, SamSegmenter
    from ..engine.trainer import Trainer
    from ..ops import grid_cuda, knn_cuda

    dev = torch.device(args.device)
    run_dir = args.run_dir
    os.makedirs(run_dir, exist_ok=True)
    train = conf.dataset.train

    scene = make_scene(num_frames=train.end_frame, num_persons=2, height=train.height, width=train.width,
                       device=dev)
    gt_masks = scene.masks.copy()  # (F, H, W, P) ground truth for IoU scoring
    rng = np.random.default_rng(args.seed)
    iou0 = gt_iou(scene.sam_logits, gt_masks)
    if args.corrupt_masks:
        scene = scene._replace(sam_logits=corrupt_sam_logits(scene, rng))
        iou0 = gt_iou(scene.sam_logits, gt_masks)
        print(f"corrupted initial masks: IoU vs GT = {iou0:.3f}")
    seq = SyntheticSequence(
        scene, num_sample=train.num_sample, using_sam=True, run_dir=run_dir,
        ratio_uncertain=0.5,
    )
    servers = build_servers(conf, seq, dev)
    if args.segmenter == "color":
        segmenter = SamSegmenter(ColorPromptPredictor(), list(scene.images), seed=args.seed)
    else:
        segmenter = PriorSegmenter()
    tr = Trainer(conf, seq, servers, run_dir=run_dir, segmenter=segmenter, device=dev)

    transl_err0 = 0.0
    if args.pose_noise > 0:
        transl = tr.ts.params()["body.transl"]
        tnoise = rng.uniform(-args.pose_noise, args.pose_noise, tuple(transl.shape)).astype(np.float32)
        with torch.no_grad():
            transl.add_(torch.as_tensor(tnoise, device=dev))
        transl_err0 = float(np.abs(tnoise).max())
        print(f"perturbed initial translations: max |err| {transl_err0*100:.1f} cm")

    transl_gt = np.asarray(scene.transl).transpose(1, 0, 2)  # (P, F, 3)

    def transl_now():
        return tr.ts.body.transl.detach().cpu().numpy().copy()

    def kernel_launches():
        return {"nn1": knn_cuda.nn1.launches, "grid_trilinear": grid_cuda.grid_trilinear.launches}

    segments, mark = [], kernel_launches()

    def end_segment():
        nonlocal mark
        peak = None
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.reset_peak_memory_stats(dev)
        now = kernel_launches()
        segments.append({"peak_gib": peak, "launches": {k: n - mark[k] for k, n in now.items()}})
        mark = now

    rows = []
    t0 = time.time()
    target = args.epochs
    while tr.epoch < target:
        upto = min(tr.epoch + args.segment, target)
        tr.fit(upto, val_every=args.segment, ckpt_every=100,
               ckpt_dir=os.path.join(run_dir, "checkpoints"))
        psnr = tr.validate(frame_idx=0)
        iou = (
            float(np.mean(seq.smpl_sam_iou))
            if getattr(seq, "smpl_sam_iou", None) is not None
            else float("nan")
        )
        logs, pose_max, n_delayed = segment_logs(os.path.join(run_dir, "metrics.jsonl"), tr.epoch - args.segment)
        # mask recovery vs ground truth: the masks training actually consumes
        # (_refresh_sam stores (F, H, W, P), same layout as scene.sam_logits)
        train_sam = (
            seq._sam_masks if seq._sam_masks is not None else scene.sam_logits
        )
        row = {
            "epoch": tr.epoch,
            "psnr": psnr,
            "mask_iou": iou,
            "gt_iou": gt_iou(train_sam, gt_masks),
            "certain": int(np.sum(seq.smpl_sam_iou >= seq.uncertain_threshold)),
            "n_delayed_pose": n_delayed,
            "transl_rmse_cm": float(np.sqrt(np.mean((transl_now() - transl_gt) ** 2)) * 100.0),
            "loss": logs.get("loss", float("nan")),
            "rgb_loss": logs.get("rgb_loss", float("nan")),
            "sam_mask_loss": logs.get("sam_mask_loss", float("nan")),
            "pose_depth_order_loss": pose_max["pose_depth_order_loss"],
            "pose_interpenetration_loss": pose_max["pose_interpenetration_loss"],
            "wall_s": time.time() - t0,
        }
        rows.append(row)
        end_segment()
        if on_segment is not None:
            on_segment(tr, row)
        print(
            f"[segment] epoch {row['epoch']} PSNR {row['psnr']:.2f} "
            f"IoU {row['mask_iou']:.3f} gtIoU {row['gt_iou']:.3f} "
            f"certain {row['certain']}/{len(seq.smpl_sam_iou)} "
            f"delayed {row['n_delayed_pose']:.0f} "
            f"transl_rmse {row['transl_rmse_cm']:.2f}cm ({row['wall_s']:.0f}s)"
        )
        # incremental write: a killed run still leaves a readable trajectory
        write_runlog(args.out, conf, rows, rows[-1]["psnr"], float("nan"),
                     0.0, time.time() - t0, run_dir, args=args)

    # final translation-only depth pass (reference depth_end mode)
    psnr_before_opt = rows[-1]["psnr"] if rows else float("nan")
    transl_before = transl_now()
    t_opt = time.time()
    if seq._sam_masks is not None:
        tr.opt_depth()
    transl_delta = float(np.abs(transl_now() - transl_before).max())
    opt_depth_s = time.time() - t_opt
    psnr_after_opt = tr.validate(frame_idx=0)
    wall = time.time() - t0
    end_segment()

    write_runlog(args.out, conf, rows, psnr_before_opt, psnr_after_opt,
                 transl_delta, wall, run_dir, args=args)
    return {"rows": rows, "iou0": iou0, "transl_err0": transl_err0, "psnr_before": psnr_before_opt,
            "psnr_after": psnr_after_opt, "transl_delta": transl_delta, "opt_depth_s": opt_depth_s, "wall_s": wall,
            "segments": segments}


def main(argv=None, on_segment=None) -> dict:
    args = parse_args(argv)
    return run(build_conf(args), args, on_segment=on_segment)


def figure_dir(path):
    """(folder beside the runlog `path` for its figures, its name as the
    markdown links it): `RUNLOG.md` -> `runlog/`, `RUNLOG_X.md` -> `runlog_x/`,
    the JAX driver's names under `docs/`."""
    stem = os.path.splitext(os.path.basename(path))[0].lower()
    if stem.startswith("runlog_"):
        stem = stem[len("runlog_"):]
    name = "runlog" if stem == "runlog" else f"runlog_{stem}"
    return os.path.join(os.path.dirname(os.path.abspath(path)), name), name


def plot_trajectory(rows, png_path):
    """PSNR and mask IoU against the epoch, with the schedule's milestones;
    raises ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots(figsize=(7, 4))
    ep = [r["epoch"] for r in rows]
    ax1.plot(ep, [r["psnr"] for r in rows], "o-", label="val PSNR (dB)")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("PSNR (dB)")
    ax2 = ax1.twinx()
    ax2.plot(ep, [r["mask_iou"] for r in rows], "s--", color="tab:orange",
             label="mask IoU")
    if any(np.isfinite(r.get("gt_iou", float("nan"))) for r in rows):
        ax2.plot(ep, [r.get("gt_iou", float("nan")) for r in rows], "^:",
                 color="tab:green", label="gt IoU")
        ax2.legend(loc="lower right", fontsize=7)
    ax2.set_ylabel("mask IoU")
    for x, lbl in [(40, "SAM loss on"), (60, "pose-opt start"),
                   (100, "pose-correction end"), (160, "pose-opt end")]:
        ax1.axvline(x, color="gray", alpha=0.4, lw=0.8)
        ax1.text(x, ax1.get_ylim()[1], lbl, rotation=90, fontsize=6,
                 va="top", ha="right")
    fig.tight_layout()
    fig.savefig(png_path, dpi=120)
    plt.close(fig)


def write_runlog(path, conf, rows, psnr_before, psnr_after, transl_delta,
                 wall, run_dir, args=None):
    md = []
    md.append("# RUNLOG — long-horizon synthetic run (full refinement schedule)\n")
    md.append(
        "One timeline through every stage of the reference's self-refinement "
        "loop (multiply_model.py:131-227, 489-519), scaled ~5x down: SAM-loss "
        "onset at epoch 40, uncertainty-driven delayed-pose before 100, "
        "pose-opt epochs (mesh depth-order + silhouette + interpenetration "
        "step losses) every 10 epochs in [60, 160), canonical-mesh refresh "
        "every 20, instance-mask + SAM stages every 20, final opt_depth "
        "translation pass.\n"
    )
    if args is not None and args.corrupt_masks:
        md.append(
            "**Corrupted start:** the initial per-person masks are damaged "
            "the way bad preprocessing damages them — person 0 dilated ~4 px "
            "on every frame, a horizontal band swapped between persons on "
            "every even frame — and the initial translations carry "
            f"U(−{args.pose_noise:.2f}, {args.pose_noise:.2f}) m noise. "
            "The refinement segmenter is the image-driven "
            "`ColorPromptPredictor` (prompts from the model's rendered "
            "instance masks + projected joints, mask from image evidence — "
            "the SAM mechanism without SAM weights). The `gt IoU` column "
            "shows whether the progressive prompting loop actually corrects "
            "the masks (the paper's central claim, "
            "multiply_model.py:489-519).\n"
        )
    device = args.device if args is not None else "device not given"
    md.append(f"Total wall-clock: **{wall/60:.1f} min** (on {device}, "
              "4 frames x 128 rays, tiny nets).\n")
    md.append("\n## Trajectory\n")
    md.append("(pose columns = max over the segment's pose-opt epochs — the "
              "mesh losses fire every `pose_opt_interval` epochs only; "
              "`gt IoU` scores the masks training actually consumes against "
              "ground truth; `certain` counts frames above the uncertainty "
              "quantile; `delayed` = MODE_DELAYED_POSE steps in the segment's "
              "max epoch)\n")
    md.append("| epoch | val PSNR (dB) | mask IoU | gt IoU | certain | "
              "delayed | transl rmse (cm) | loss | rgb | sam | "
              "pose depth-order | pose interp |")
    md.append("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        md.append(
            f"| {r['epoch']} | {r['psnr']:.2f} | {r['mask_iou']:.3f} | "
            f"{r.get('gt_iou', float('nan')):.3f} | {r.get('certain', 0)} | "
            f"{r.get('n_delayed_pose', 0):.0f} | "
            f"{r.get('transl_rmse_cm', float('nan')):.2f} | "
            f"{r['loss']:.4f} | {r['rgb_loss']:.4f} | {r['sam_mask_loss']:.4f} | "
            f"{r['pose_depth_order_loss']:.5f} | "
            f"{r['pose_interpenetration_loss']:.5f} |"
        )
    md.append("\n## Final opt_depth pass\n")
    md.append(f"- PSNR before: {psnr_before:.2f} dB, after: {psnr_after:.2f} dB")
    md.append(f"- max |Δtransl| applied by the pass: {transl_delta:.4f}")
    if args is not None and args.pose_noise > 0:
        md.append(
            "- this run starts from noisy translations (see header); the "
            "trajectory's `transl rmse` column shows how much the training "
            "loop itself recovered before this pass ran.\n"
        )
    else:
        md.append(
            "- note: this synthetic run starts from ground-truth "
            "translations, so the pass has nothing to fix — see the "
            "perturbation demo (`examples/optdepth_demo.py`) for opt_depth "
            "recovering corrupted translations, its actual job.\n"
        )

    first = next((r for r in rows if np.isfinite(r["psnr"])), None)
    last = next((r for r in reversed(rows) if np.isfinite(r["psnr"])), None)
    if first and last:
        md.append(
            f"\nPSNR {first['psnr']:.2f} -> {last['psnr']:.2f} dB across the "
            f"schedule; mask IoU {first['mask_iou']:.3f} -> "
            f"{last['mask_iou']:.3f}.\n"
        )

    art_dir, art_link = figure_dir(path)
    os.makedirs(art_dir, exist_ok=True)
    try:
        plot_trajectory(rows, os.path.join(art_dir, "psnr_iou.png"))
        md.append(f"![trajectory]({art_link}/psnr_iou.png)\n")
    except ImportError as e:
        print(f"plotting skipped: {e}")
    # keep the first and last validation renders as visual artifacts
    vals = sorted(glob.glob(os.path.join(run_dir, "val", "*.png")))
    if vals:
        shutil.copy(vals[0], os.path.join(art_dir, "val_first.png"))
        shutil.copy(vals[-1], os.path.join(art_dir, "val_last.png"))
        md.append("First vs last validation render (GT | prediction):\n")
        md.append(f"![first]({art_link}/val_first.png)")
        md.append(f"![last]({art_link}/val_last.png)\n")

    with open(path, "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
