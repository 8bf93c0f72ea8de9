"""Training entry of the port.

    python -m multiply_tpu_torch.cli.train --conf confs/synthetic_base.yaml [--max_epochs N]
        [--run_dir D] [--is_continue] [--data_root R] [--set model.it_per_loop=5 ...] [--device cpu]
        [--profile N] [--devices N]

Counterpart of the repository's `train.py`: the composed YAML config with
dotted overrides, the sequence (the synthetic scene or a preprocessed Hi4D
directory), per-person SMPL servers, the SAM stage and `Trainer.fit`. With a
`sam_checkpoint` file (the official `sam_vit_h_4b8939.pth`, loaded strictly)
the SAM stage is `SamSegmenter` over the frames; without one it is
`PriorSegmenter`. `--profile N` traces N training steps of `train_epoch`
(producer, queue, the configured modes) after two warm ones, prints the
card's time by category and the program's spans and counters, writes
`<run_dir>/profile/` (`trace.json`, `summary.json`, `spans.json`) and
exits. Run artifacts (checkpoints, stage_* files, validation renders,
metrics.jsonl) go to outputs/<exp>/<run>/ unless --run_dir says otherwise.
Runs on the card; `--device cpu` is for tests at tiny widths (`--set` them).
A synthetic sequence ignores `dataset.train.ratio_uncertain`, as the JAX
entry does.

`--devices N` (or `devices: N` in the config, read as the JAX entry reads
them) splits each step's rays over N processes (`parallel/sharding.py`): rank
r on `cuda:r` with NCCL, rank 0 in this process and the others spawned; more
ranks than visible cards is refused. With `--device cpu` the N ranks are
`gloo` processes on the CPU, for tests. Rank 0 runs the stages and writes
every file; `--profile` traces rank 0's steps. A rank waits in one
collective at most `dist_timeout_s` (config, default 3600 s: the others wait
there while rank 0 runs the epoch-end stages).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import yaml

RENDEZVOUS_FILE = ".rendezvous"  # under run_dir, for `--devices N`


def parse_overrides(sets: list[str]) -> dict:
    """["a.b=1", ...] -> {"a": {"b": 1}}, each value YAML-parsed. Raises a
    ValueError naming the argument when it lacks "=", when its key path has
    an empty part, or when it sets a key under one that an earlier argument
    gave a value that is not a mapping."""
    overrides: dict = {}
    for kv in sets:
        key, eq, val = kv.partition("=")
        if not eq:
            raise ValueError(f"--set {kv!r}: expected key.path=value")
        *path, last = key.strip().split(".")
        if not all(part.strip() for part in (*path, last)):
            raise ValueError(f"--set {kv!r}: the key path {key.strip()!r} has an empty part")
        node = overrides
        for p in path:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"--set {kv!r}: {p!r} already has the value {node!r}, not a mapping")
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
        # as the JAX entry: a synthetic sequence keeps its default ratio_uncertain (0.5)
        return SyntheticSequence(
            scene, num_sample=train_opt.num_sample if num_sample is None else num_sample,
            using_sam=train_opt.get("using_SAM", True), run_dir=run_dir,
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
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="split each step's rays over N processes, one device each (cuda:0..N-1)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N training steps, write <run_dir>/profile/ and exit")
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


def load_conf(args):
    from ..config import load_config

    return load_config(args.conf, overrides=parse_overrides(args.sets) or None)


def run_dir_of(args, conf) -> str:
    return args.run_dir or os.path.join("outputs", str(conf.get("exp", "exp")), str(conf.get("run", "run")))


def build_trainer(args, group=None):
    """(trainer, config, checkpoint directory) for parsed arguments; resumes
    from the latest epoch checkpoint with --is_continue or model.is_continue.
    With a ray group the trainer is this rank's, on the group's device; only
    rank 0 builds the SAM stage (the others run no stage)."""
    from ..engine.trainer import Trainer

    conf = load_conf(args)
    run_dir = run_dir_of(args, conf)
    os.makedirs(run_dir, exist_ok=True)
    device = args.device if group is None else str(group.device)
    seq = build_sequence(conf, run_dir, args.data_root, device=device)
    segmenter = build_segmenter(conf, seq, device) if group is None or group.rank == 0 else None
    trainer = Trainer(conf, seq, build_servers(conf, seq, device), run_dir=run_dir, segmenter=segmenter,
                      seed=conf.get("seed", 42), device=device, group=group)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if args.is_continue or conf.model.get("is_continue", False):
        ckpt = latest_checkpoint(run_dir)
        if ckpt:
            print(f"resuming from {ckpt}")
            trainer.load_checkpoint(ckpt)
    return trainer, conf, ckpt_dir


def run(trainer, args, conf, ckpt_dir):
    """Train as configured, or profile `--profile N` steps; returns the trainer."""
    if args.profile:
        from ..utils.profiling import profile_training_steps

        profile_training_steps(trainer, args.profile, os.path.join(trainer.run_dir, "profile"))
        return trainer
    trainer.fit(args.max_epochs or conf.get("max_epochs", 10_000), ckpt_dir=ckpt_dir)
    return trainer


def rank_devices(device: str, n: int) -> tuple[list, str]:
    """(device of each of n ranks, backend): cuda:0..n-1 with NCCL, refused
    beyond the visible cards; the CPU n times with gloo."""
    import torch

    if torch.device(device).type != "cuda":
        return [device] * n, "gloo"
    have = torch.cuda.device_count()
    if n > have:
        raise SystemExit(f"devices={n}: {n} CUDA devices asked for, {have} visible")
    return [f"cuda:{r}" for r in range(n)], "nccl"


def train_rank(group, args):
    """One rank of `--devices N` (a module-level function: spawned ranks
    import it): rank 0 trains and returns its trainer, the others follow it."""
    trainer, conf, ckpt_dir = build_trainer(args, group)
    if group.rank != 0:
        trainer.follow()
        return None
    try:
        return run(trainer, args, conf, ckpt_dir)
    finally:
        trainer.release_followers()


def train_on_ranks(args, devices: list, backend: str):
    """Train with the rays of each step split over one rank per entry of
    `devices` (rank 0 in this process); returns rank 0's trainer. The entry
    calls it with `rank_devices`; a caller may name any devices and backend
    (two ranks on one card need gloo)."""
    from ..parallel import launch

    conf = load_conf(args)
    run_dir = run_dir_of(args, conf)
    os.makedirs(run_dir, exist_ok=True)
    args = argparse.Namespace(**{**vars(args), "run_dir": run_dir})
    return launch(train_rank, (args,), devices, backend, os.path.join(run_dir, RENDEZVOUS_FILE),
                  timeout_s=float(conf.get("dist_timeout_s", 3600)))


def main(argv=None):
    """Train as configured (or profile `--profile N` steps); returns the
    trainer (rank 0's with `--devices N`)."""
    args = parse_args(argv)
    conf = load_conf(args)
    devices = int(args.devices or conf.get("devices", None) or 0)
    if devices > 1:
        return train_on_ranks(args, *rank_devices(args.device, devices))
    trainer, conf, ckpt_dir = build_trainer(args)
    return run(trainer, args, conf, ckpt_dir)


if __name__ == "__main__":
    main()
