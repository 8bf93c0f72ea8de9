"""Training entry of the port.

    python -m multiply_tpu_torch.cli.train --conf confs/synthetic_base.yaml [--max_epochs N]
        [--run_dir D] [--is_continue] [--data_root R] [--set model.it_per_loop=5 ...] [--device cpu]
        [--profile N]

Counterpart of the repository's `train.py`: the composed YAML config with
dotted overrides, the sequence (the synthetic scene or a preprocessed Hi4D
directory), per-person SMPL servers, the SAM stage and `Trainer.fit`. With a
`sam_checkpoint` file (the official `sam_vit_h_4b8939.pth`, loaded strictly)
the SAM stage is `SamSegmenter` over the frames; without one it is
`PriorSegmenter`. `--profile N` traces N training steps after two warm ones,
writes `<run_dir>/profile/summary.json` and exits. Run artifacts
(checkpoints, stage_* files, validation renders, metrics.jsonl) go to
outputs/<exp>/<run>/ unless --run_dir says otherwise. Runs on the card;
`--device cpu` is for tests at tiny widths (`--set` them). Not ported yet, and
refused rather than ignored: several devices (--devices; ROADMAP.md, queue 1).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import yaml

NOT_PORTED = "is not ported to the PyTorch package yet (ROADMAP.md, queue 1)"


def parse_overrides(sets: list[str]) -> dict:
    """["a.b=1", ...] -> {"a": {"b": 1}}, each value YAML-parsed."""
    overrides: dict = {}
    for kv in sets:
        key, _, val = kv.partition("=")
        node = overrides
        *path, last = key.strip().split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = yaml.safe_load(val)
    return overrides


def build_sequence(conf, run_dir: str, data_root: str | None = None, num_sample: int | None = None,
                   device="cuda"):
    """The configured training sequence: the synthetic scene, made on `device`,
    or a preprocessed Hi4D directory (`data_root`, default data/<data_dir>)."""
    train_opt = conf.dataset.train
    if train_opt.dataset == "Synthetic":
        from ..data.synthetic import make_scene
        from ..data.synthetic_sequence import SyntheticSequence

        scene = make_scene(
            num_frames=train_opt.get("end_frame", 4), num_persons=train_opt.get("num_person", 2),
            height=train_opt.get("height", 48), width=train_opt.get("width", 64), device=device,
        )
        return SyntheticSequence(
            scene, num_sample=train_opt.num_sample if num_sample is None else num_sample,
            using_sam=train_opt.get("using_SAM", True), ratio_uncertain=train_opt.get("ratio_uncertain", 0.5),
            run_dir=run_dir,
        )
    from ..data.dataset import Hi4DSequence

    return Hi4DSequence(
        data_root or os.path.join("data", train_opt.data_dir), start_frame=train_opt.start_frame,
        end_frame=train_opt.end_frame, num_sample=train_opt.num_sample if num_sample is None else num_sample,
        using_sam=train_opt.get("using_SAM", True), ratio_uncertain=train_opt.get("ratio_uncertain", 0.5),
        run_dir=run_dir,
    )


def build_servers(conf, seq, device="cuda") -> list:
    """Per-person SMPL servers: the SMPL pickles at `smpl_model_path` if they
    exist, else the synthetic test body."""
    from ..body.server import SMPLServer
    from ..body.smpl import load_smpl_model, synthetic_body_model

    model_path = conf.get("smpl_model_path", None)
    servers = []
    for p in range(seq.num_person):
        gender = seq.genders[p] if hasattr(seq, "genders") else "neutral"
        if model_path and os.path.exists(model_path):
            body = load_smpl_model(model_path, gender=gender, device=device)
        else:
            if model_path:
                print(f"WARNING: smpl_model_path={model_path} does not exist: falling back to the SYNTHETIC "
                      "test body. Real sequences will produce garbage geometry (docs/REAL_DATA.md).")
            body = synthetic_body_model(device=device)
        servers.append(SMPLServer.create(body, betas=np.asarray(seq.shape[p])))
    return servers


def latest_checkpoint(run_dir: str, include_last: bool = False) -> str | None:
    cands = sorted(glob.glob(os.path.join(run_dir, "checkpoints", "epoch_*")))
    if include_last:
        cands += sorted(glob.glob(os.path.join(run_dir, "checkpoints", "last")))
    return cands[-1] if cands else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conf", required=True)
    ap.add_argument("--data_root", default=None, help="override dataset root")
    ap.add_argument("--max_epochs", type=int, default=None)
    ap.add_argument("--run_dir", default=None)
    ap.add_argument("--is_continue", action="store_true")
    ap.add_argument("--devices", type=int, default=0, metavar="N", help=f"several devices {NOT_PORTED}")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N training steps, write <run_dir>/profile/summary.json and exit")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL", dest="sets",
                    help="dotted config override, e.g. --set model.stage_overlap=true (YAML value; repeatable)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for tests)")
    return ap.parse_args(argv)


def frame_images(seq) -> list:
    """One callable per frame giving its uint8 RGB image, rgb x 255 truncated
    as the JAX entry does."""
    def frame(i):
        item = seq.get_eval_item(i)
        return (item["rgb"].reshape(*item["img_size"], 3) * 255).astype(np.uint8)

    return [lambda i=i: frame(i) for i in range(len(seq))]


def build_segmenter(conf, seq, device="cuda"):
    """`SamSegmenter` over the frames when the configured `sam_checkpoint`
    (top level, else under `model`) is a file, else `PriorSegmenter`."""
    from ..engine.sam_stage import PriorSegmenter, SamSegmenter
    from ..models.sam import build_sam_predictor

    path = conf.get("sam_checkpoint", None) or conf.model.get("sam_checkpoint", None)
    if path and os.path.exists(str(path)):
        return SamSegmenter(build_sam_predictor(str(path), device=device), frame_images(seq))
    why = f"sam_checkpoint={path} does not exist" if path else "no sam_checkpoint configured"
    print(f"SAM stage: PriorSegmenter (the rendered instance masks): {why}")
    return PriorSegmenter()


def build_trainer(args):
    """(trainer, config, checkpoint directory) for parsed arguments; resumes
    from the latest epoch checkpoint with --is_continue or model.is_continue."""
    from ..config import load_config
    from ..engine.trainer import Trainer

    if args.devices > 1:
        raise SystemExit(f"--devices {args.devices}: training on several devices {NOT_PORTED}")
    conf = load_config(args.conf, overrides=parse_overrides(args.sets) or None)
    run_dir = args.run_dir or os.path.join("outputs", str(conf.get("exp", "exp")), str(conf.get("run", "run")))
    os.makedirs(run_dir, exist_ok=True)
    seq = build_sequence(conf, run_dir, args.data_root, device=args.device)
    trainer = Trainer(conf, seq, build_servers(conf, seq, args.device), run_dir=run_dir,
                      segmenter=build_segmenter(conf, seq, args.device), seed=conf.get("seed", 42),
                      device=args.device)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if args.is_continue or conf.model.get("is_continue", False):
        ckpt = latest_checkpoint(run_dir)
        if ckpt:
            print(f"resuming from {ckpt}")
            trainer.load_checkpoint(ckpt)
    return trainer, conf, ckpt_dir


def main(argv=None):
    """Train as configured (or profile `--profile N` steps); returns the trainer."""
    args = parse_args(argv)
    trainer, conf, ckpt_dir = build_trainer(args)
    if args.profile:
        from ..utils.profiling import profile_training_steps

        profile_training_steps(trainer, args.profile, os.path.join(trainer.run_dir, "profile"))
        return trainer
    trainer.fit(args.max_epochs or conf.get("max_epochs", 10_000), ckpt_dir=ckpt_dir)
    return trainer


if __name__ == "__main__":
    main()
