"""Inference entry of the port: full-image renders and mesh files from a
checkpoint.

    python -m multiply_tpu_torch.cli.test --conf confs/synthetic_base.yaml [--run_dir D]
        [--mode default|free_view|novel_view] [--frames N] [--export_meshes] [--device cpu]

Counterpart of the repository's `test.py`. Loads the latest checkpoint of the
run (epoch_* first, else `last`) and writes test/test_rendering/%04d.png (GT
beside the render in the default mode), test_fg_rendering/, test_normal/,
test_mask/, test_instance_mask/<p>/ and, with --export_meshes,
test_mesh/<p>/<idx>_{canonical,deformed}.ply under <run_dir>/test.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .train import build_sequence, build_servers, latest_checkpoint, parse_overrides


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conf", required=True)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--run_dir", default=None)
    ap.add_argument("--ckpt", default=None, help="checkpoint path (default: latest)")
    ap.add_argument("--mode", default="default", choices=["default", "free_view", "novel_view"])
    ap.add_argument("--frames", type=int, default=None, help="limit frames")
    ap.add_argument("--export_meshes", action="store_true")
    ap.add_argument("--novel_view", type=int, default=None, help="held-out GT camera id (novel_view mode)")
    ap.add_argument("--current_view", type=int, default=None, help="GT camera id of the training camera")
    ap.add_argument("--gt_cameras", default=None, help="path to rgb_cameras.npz (ids/intrinsics/extrinsics)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL", dest="sets",
                    help="dotted config override (YAML value; repeatable)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    return ap.parse_args(argv)


def main(argv=None) -> str:
    """Render as configured; returns the output directory."""
    from ..config import load_config
    from ..engine.evaluator import Evaluator
    from ..engine.sam_stage import PriorSegmenter
    from ..engine.trainer import Trainer

    args = parse_args(argv)
    conf = load_config(args.conf, overrides=parse_overrides(args.sets) or None)
    run_dir = args.run_dir or os.path.join("outputs", str(conf.get("exp", "exp")), str(conf.get("run", "run")))
    seq = build_sequence(conf, run_dir, args.data_root, num_sample=-1, device=args.device)
    servers = build_servers(conf, seq, args.device)
    trainer = Trainer(conf, seq, servers, run_dir=run_dir, segmenter=PriorSegmenter(), device=args.device)

    ckpt = args.ckpt or latest_checkpoint(run_dir, include_last=True)
    if ckpt:
        print(f"loading {ckpt}")
        trainer.load_checkpoint(ckpt)
    else:
        print("WARNING: no checkpoint found; rendering from initialization")

    ev = Evaluator(trainer.renderer, trainer.person_state, servers,
                   pixel_per_batch=conf.dataset.test.get("pixel_per_batch", 512))
    novel_cams = _resolve_novel_cameras(args, conf, seq) if args.mode == "novel_view" else None
    n_frames = args.frames or len(seq)
    out_dir = os.path.join(run_dir, "test")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_frames):
        item = seq.get_eval_item(i)
        if args.mode == "free_view":
            item = _orbit_camera(item, angle_deg=i * (360.0 / max(n_frames, 1)))
        elif args.mode == "novel_view":
            cam = novel_cams[i]
            item = dict(item)
            item["P"] = cam["P"]
            item["intrinsics"] = np.asarray(cam["intrinsics"], np.float32)
            item["pose"] = np.asarray(cam["pose"], np.float32)
            item.pop("rgb", None)
        merged = ev.render_image(trainer.ts.body, item, epoch=trainer.epoch, person_state=trainer.person_state)
        gt = (np.asarray(item["rgb"], np.float32).reshape(*item["img_size"], 3)
              if "rgb" in item and args.mode == "default" else None)
        ev.save_outputs(out_dir, i, merged, gt)
        msg = f"frame {i}: wrote renders"
        if "psnr" in merged:
            msg += f" (PSNR {merged['psnr']:.2f} dB)"
        print(msg)
        if args.export_meshes:
            fns = [trainer.canonical_sdf_fn(p) for p in range(seq.num_person)]
            ev.export_meshes(fns, trainer.ts.body, trainer.person_state.deformer, i, float(seq.scale), out_dir)
    return out_dir


def _resolve_novel_cameras(args, conf, seq) -> list[dict]:
    """Per-frame cameras of the held-out GT view. The flags override the
    dataset.test keys (novel_view, current_view, GT_DIR/pair/action)."""
    from ..data.dataset import novel_view_cameras

    test_opt = conf.dataset.get("test", {})
    nv = args.novel_view if args.novel_view is not None else test_opt.get("novel_view")
    cv = args.current_view if args.current_view is not None else test_opt.get("current_view")
    path = args.gt_cameras
    if path is None and all(k in test_opt for k in ("GT_DIR", "pair", "action")):
        path = os.path.join(str(test_opt["GT_DIR"]), str(test_opt["pair"]), str(test_opt["action"]),
                            "cameras", "rgb_cameras.npz")
    if nv is None or cv is None or path is None:
        raise SystemExit("novel_view mode needs --novel_view, --current_view and --gt_cameras "
                         "(or dataset.test.{novel_view,current_view,GT_DIR,pair,action})")
    if not hasattr(seq, "scale_mats"):
        raise SystemExit("novel_view mode needs a dataset with cameras_normalize.npz")
    gt = dict(np.load(path))
    print(f"novel view {nv} (training camera = GT view {cv}) from {path}")
    return novel_view_cameras(seq, gt, current_view=int(cv), novel_view=int(nv))


def _orbit_camera(item: dict, angle_deg: float) -> dict:
    """Free-view synthesis: rotate the camera about the scene's y axis."""
    from scipy.spatial.transform import Rotation

    pose = np.asarray(item["pose"]).copy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_euler("y", angle_deg, degrees=True).as_matrix()
    item = dict(item)
    item["pose"] = (T @ pose).astype(np.float32)
    item.pop("rgb", None)
    return item


if __name__ == "__main__":
    main()
