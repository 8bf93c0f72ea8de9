"""How much the corrupted long run's outcome owes to the initial weights, to
the trainer's seed and to the device, in the port and in the JAX package.

Not a test (pytest collects nothing here); seven commands:

    python tests/torch_init_study.py export OUT.npz [KEY]
        On the CPU: the JAX package's initial network weights at KEY (default
        42, the trainers' default seed) at the long run's configuration
        (`multiply_tpu_torch.examples.longrun_synthetic.build_conf`), under the
        port's parameter names and layout.
    python tests/torch_init_study.py run INIT [--no_final_pass] [longrun_synthetic flags]
        The port's `longrun_synthetic` (no JAX; on the card unless the flags
        say `--device cpu`) with its trainer seeded by INIT when INIT is an
        integer, or with the network started from an npz of `export` when
        INIT is FILE.npz or FILE.npz@SEED (trainer seed SEED, default 42),
        e.g. `run outputs/init.npz --epochs 180
        --corrupt_masks --pose_noise 0.05 --segmenter color --run_dir
        outputs/init_study --out outputs/init_study/RUNLOG_CORRUPT.md`.
    python tests/torch_init_study.py jax KEY [--no_final_pass] [examples/longrun_synthetic.py flags]
        On the CPU: the JAX package's own driver with its trainer seeded by
        KEY. Run it from a scratch directory: the driver writes its figures
        under `docs/` of the working directory.
    python tests/torch_init_study.py sweep JOBS OUT INIT [INIT ...] -- [run flags]
        `run` for each INIT, JOBS processes at a time on one card (or on the
        CPU), into OUT/<INIT>/ (its log, run dir and runlog); then `table`.
    python tests/torch_init_study.py table RUNLOG [RUNLOG ...]
        For runlogs that either package's driver wrote: gt IoU and val PSNR
        by segment, and how many segments from epoch 100 on hold path L's
        band, gt IoU >= 0.95.
    python tests/torch_init_study.py pair OUT INIT [longrun_synthetic flags]
        The port's long run from INIT (an npz of `export`, FILE.npz@SEED)
        twice at once, on the card and with `--device cpu`, into OUT/cuda/
        and OUT/cpu/ (`pair-run`). Both runs make the scene on the CPU and
        draw every step's noise from one CPU `torch.Generator` (seeded by
        SEED) moved to the run's device, and must start bit-equal. Each
        saves the trainer's state at every segment (`one_state.capture`) and
        records its discrete choices: each step's frame and mode, each
        epoch's `certain` flags, each instance-mask and SAM file. Then
        `pair-table` prints, by segment, gt IoU, PSNR and rmse of both runs
        beside the JAX package's key-42 rows (RUNLOG_CORRUPT.md), the
        largest parameter gap, and the first epoch at which a choice parts;
        and `pair-check` runs the step and every stage on the card and on
        the CPU from the card's state at the last segment where the runs
        agree and at the first where they part. E.g. `pair outputs/pair
        outputs/init42.npz@42 --epochs 180 --corrupt_masks --pose_noise 0.05
        --segmenter color --no_final_pass`. The card run takes ~5 min, the
        CPU run about an hour on 2 cores: each half can run on its own
        machine with `pair-run DEVICE OUT/DEVICE INIT <flags>`, the tables
        after with `pair-table OUT`.
    python tests/torch_init_study.py pair-check OUT EPOCH [EPOCH ...] -- [longrun flags]
        `one_state.compare_devices` from OUT/cuda/state_<EPOCH>.pt on the
        card and on the CPU; the gaps to OUT/one_state_<EPOCH>.json.

`--no_final_pass` leaves out the final opt_depth pass after the last segment
(the schedule's own opt_depth epochs still run), so that a sweep over seeds
reads the segments' rows alone.
"""

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def port_conf():
    from multiply_tpu_torch.examples import longrun_synthetic

    return longrun_synthetic.build_conf(longrun_synthetic.parse_args(["--device", "cpu"])).model


def jax_init(key: int) -> dict:
    """JAX's initial network weights at `key`, by port parameter name, in the port's layout."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from multiply_tpu.config import Config as JaxConfig
    from multiply_tpu.models.renderer import MultiplyRenderer as JaxRenderer
    from multiply_tpu_torch import convert
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    conf = port_conf()
    tree = jax.tree.map(np.asarray, jax.jit(JaxRenderer(JaxConfig(conf.to_dict()), 2, 4).init_params)(
        jax.random.PRNGKey(key)))
    out = {}
    for name, p in MultiplyRenderer(conf, 2, 4, device="cpu").named_parameters():
        leaf = convert.flax_leaf({"net": tree}, f"net.{name}")
        out[name] = np.ascontiguousarray(np.swapaxes(leaf, -1, -2) if name.endswith("weight") else leaf
                                         ).reshape(tuple(p.shape)).astype(np.float32)
    return out


def study_trainer(base, seed: int, last_epoch: int | None, init=None):
    """`base` seeded by `seed`, its network copied from `init` (port names) if
    given, and its opt_depth a no-op once the run has reached `last_epoch`
    (the final pass; None keeps it)."""

    class StudyTrainer(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **{**kw, "seed": seed})
            if init is not None:
                import torch

                with torch.no_grad():
                    for name, p in self.renderer.named_parameters():
                        p.copy_(torch.as_tensor(init[name], device=p.device))

        def opt_depth(self):
            if last_epoch is not None and self.epoch >= last_epoch:
                print(f"final opt_depth pass left out at epoch {self.epoch}", flush=True)
                return
            super().opt_depth()

    return StudyTrainer


def final_epoch(argv: list) -> int | None:
    """The run's last epoch, when `--no_final_pass` is in `argv` (taken out)."""
    if "--no_final_pass" not in argv:
        return None
    argv.remove("--no_final_pass")
    return int(argv[argv.index("--epochs") + 1]) if "--epochs" in argv else 200


def on_card(argv: list) -> bool:
    return "--device" not in argv or argv[argv.index("--device") + 1] != "cpu"


def build_kernels() -> None:
    from multiply_tpu_torch import cuda_build, native

    cuda_build.build_all(cuda_build.KERNELS)
    native._lib()


def run(init: str, argv: list) -> dict:
    import torch

    from multiply_tpu_torch.engine import trainer as trainer_module
    from multiply_tpu_torch.examples import longrun_synthetic

    last = final_epoch(argv)
    if init.lstrip("-").isdigit():
        trainer_module.Trainer = study_trainer(trainer_module.Trainer, int(init), last)
        print(f"the port's own initial draw, trainer seed {init}", flush=True)
    else:
        path, _, seed = init.partition("@")
        seed = int(seed or 42)
        trainer_module.Trainer = study_trainer(trainer_module.Trainer, seed, last, init=np.load(path))
        print(f"network weights from {path}, trainer seed {seed}", flush=True)
    if on_card(argv):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build_kernels()
    return longrun_synthetic.main(argv)


def run_jax(key: int, argv: list) -> None:
    import importlib.util

    import jax

    jax.config.update("jax_platforms", "cpu")
    from multiply_tpu.engine import trainer as trainer_module

    trainer_module.Trainer = study_trainer(trainer_module.Trainer, key, final_epoch(argv))
    print(f"the JAX package's driver, trainer key {key}", flush=True)
    spec = importlib.util.spec_from_file_location("jax_longrun", os.path.join(ROOT, "examples", "longrun_synthetic.py"))
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    sys.argv = ["longrun_synthetic.py", *argv]
    driver.main()


def read_runlog(path: str) -> list:
    """(epoch, val PSNR, gt IoU, transl rmse cm) of each row of a runlog that
    either package's `longrun_synthetic` wrote."""
    rows = []
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) == 12 and cells[0].isdigit():
                rows.append((int(cells[0]), float(cells[1]), float(cells[3]), float(cells[6])))
    return rows


def table(paths: list, iou_min: float = 0.95, psnr_min: float = 16.5, from_epoch: int = 100) -> None:
    """For each runlog: gt IoU and val PSNR by segment, and how many segments
    from `from_epoch` on hold gt IoU >= `iou_min` (path L's bands)."""
    held = total = 0
    for path in paths:
        rows = read_runlog(path)
        late = [r for r in rows if r[0] >= from_epoch]
        ok = sum(r[2] >= iou_min for r in late)
        held, total = held + ok, total + len(late)
        last = rows[-1] if rows else (0, float("nan"), float("nan"), float("nan"))
        print(f"{path}: gt IoU {[r[2] for r in rows]}; PSNR {[r[1] for r in rows]}; at epoch {last[0]} PSNR "
              f"{last[1]} (>= {psnr_min}: {last[1] >= psnr_min}), transl rmse {last[3]} cm; gt IoU >= {iou_min} at "
              f"{ok} of {len(late)} segments from epoch {from_epoch}", flush=True)
    print(f"all: gt IoU >= {iou_min} at {held} of {total} segments from epoch {from_epoch}", flush=True)


def sweep(jobs: int, out: str, inits: list, argv: list) -> None:
    """`run` for each of `inits` at once, `jobs` at a time in processes of
    their own (2 CPU threads each), into OUT/<init>/; then `table`."""
    import subprocess
    import time

    if on_card(argv):
        build_kernels()  # once, before the processes that load them start
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    pending, running, names = list(inits), [], []
    while pending or running:
        running = [p for p in running if p.poll() is None]
        while pending and len(running) < jobs:
            init = pending.pop(0)
            name = os.path.basename(init).replace(".npz", "")
            d = os.path.join(out, name)
            os.makedirs(d, exist_ok=True)
            names.append(name)
            with open(os.path.join(d, "log.txt"), "w") as log:
                running.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "run", init, *argv, "--run_dir", os.path.join(d, "run"),
                     "--out", os.path.join(d, "RUNLOG_CORRUPT.md")], stdout=log, stderr=subprocess.STDOUT, env=env))
        time.sleep(2)
    table([os.path.join(out, n, "RUNLOG_CORRUPT.md") for n in names])


def init_weights(init: str):
    """(npz weights by port name, trainer seed) of FILE.npz[@SEED]."""
    path, _, seed = init.partition("@")
    return np.load(path), int(seed or 42)


def pair_trainer(base, seed: int, last_epoch, init, out: str):
    """`study_trainer` whose step noise comes from a CPU generator seeded by
    `seed` (moved to the trainer's device), whose discrete choices are
    recorded in `events`, and whose first construction writes a digest of
    its initial state to OUT/start.json."""
    import hashlib
    import json

    import torch

    from multiply_tpu_torch.examples import one_state

    study = study_trainer(base, seed, last_epoch, init=init)

    def digest(arrays) -> str:
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    class PairTrainer(study):
        events: list = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            host_gen = torch.Generator().manual_seed(seed)
            self.builder.draw_noise = lambda batch, pose_batch=None, generator=None: one_state.host_noise(
                self.builder, batch.uv.shape[0], pose_batch, host_gen, self.device)
            scene = self.seq.scene
            start = {"params": digest(p.detach().cpu().numpy() for p in self.ts.params().values()),
                     "scene": digest([scene.images, scene.masks, scene.sam_logits])}
            with open(os.path.join(out, "start.json"), "w") as f:
                json.dump(start, f)
            # the SMPL bodies' grids are baked on the run's device: compared by value
            torch.save({k: v.cpu() for k, v in self.person_state.cano_grid.items()}, os.path.join(out, "start_grids.pt"))

        def fit(self, *args, **kw):
            if self.epoch == 0:  # the state the run starts from, its translations perturbed
                torch.save(one_state.capture(self), os.path.join(out, "state_00000.pt"))
            return super().fit(*args, **kw)

        def train_epoch(self):
            pick = self.seq.sam_pickup
            self.events.append((self.epoch, "certain", [bool(x) for x in pick.iou >= pick.threshold]))
            return super().train_epoch()

        def train_step(self, batch, pose_batch=None):
            self.events.append((self.epoch, "step", [int(batch.frame_idx), int(batch.mode)]))
            return super().train_step(batch, pose_batch)

        def instance_mask_stage(self, *args, **kw):
            super().instance_mask_stage(*args, **kw)
            self._record("stage_instance_mask", "all_person_smpl_mask.npy", kw.get("epoch"))

        def sam_stage(self, epoch=None):
            super().sam_stage(epoch)
            self._record("stage_sam_mask", "sam_opt_mask.npy", epoch)

        def _record(self, stage, name, epoch):
            ep = self.epoch if epoch is None else epoch
            arr = np.load(os.path.join(self.run_dir, stage, f"{ep:05d}", name))
            self.events.append((ep, stage, digest([arr > 0]) if stage == "stage_sam_mask" else digest([arr])))

    return PairTrainer


def pair_run(device: str, out: str, init: str, argv: list) -> None:
    """One run of `pair` on `device`, into `out`."""
    import json

    import torch

    from multiply_tpu_torch.data import synthetic
    from multiply_tpu_torch.engine import trainer as trainer_module
    from multiply_tpu_torch.examples import longrun_synthetic, one_state

    os.makedirs(out, exist_ok=True)
    weights, seed = init_weights(init)
    last = final_epoch(argv)
    cls = pair_trainer(trainer_module.Trainer, seed, last, weights, out)
    trainer_module.Trainer = cls
    real_scene = synthetic.make_scene
    scene_gap = {}

    def cpu_scene(*args, **kw):
        scene = real_scene(*args, **{**kw, "device": "cpu"})
        if torch.device(kw.get("device", "cuda")).type == "cuda":  # what the card alone would have made
            own = real_scene(*args, **kw)
            scene_gap.update({k: float(np.abs(np.asarray(getattr(own, k), np.float64)
                                              - np.asarray(getattr(scene, k), np.float64)).max())
                              for k in ("images", "masks", "sam_logits")})
        return scene

    synthetic.make_scene = cpu_scene
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build_kernels()

    def on_segment(tr, row):
        torch.save(one_state.capture(tr), os.path.join(out, f"state_{row['epoch']:05d}.pt"))
        with open(os.path.join(out, "events.json"), "w") as f:
            json.dump({"events": cls.events, "rows": rows + [row], "scene_gap": scene_gap}, f)
        rows.append(row)

    rows: list = []
    res = longrun_synthetic.main([*argv, "--device", device, "--run_dir", os.path.join(out, "run"),
                                  "--out", os.path.join(out, "RUNLOG_CORRUPT.md")], on_segment=on_segment)
    with open(os.path.join(out, "events.json"), "w") as f:
        json.dump({"events": cls.events, "rows": rows, "scene_gap": scene_gap,
                   "final": {k: res[k] for k in ("psnr_before", "psnr_after", "transl_delta")}}, f)


def first_parting(a: list, b: list):
    """(epoch, what) of the first recorded choice in which two runs differ, or None."""
    for x, y in zip(a, b):
        if x != y:
            return x[0], f"{x[1]}: {x[2]} against {y[2]}"
    if len(a) != len(b):
        return (a if len(a) > len(b) else b)[min(len(a), len(b))][0], "one run recorded more"
    return None


def pair_table(out: str, devices=("cuda", "cpu")) -> dict:
    """`pair`'s table from OUT/<device>/ of both runs; returns the segments'
    epochs, the first parting and the parameter gaps."""
    import json

    import torch

    runs = {}
    for d in devices:
        with open(os.path.join(out, d, "events.json")) as f:
            runs[d] = json.load(f)
        with open(os.path.join(out, d, "start.json")) as f:
            runs[d]["start"] = json.load(f)
    a, b = (runs[d] for d in devices)
    same_start = a["start"] == b["start"]
    print(f"pair: start bit-equal (parameters, scene): {same_start} {a['start']} | {b['start']}", flush=True)
    ga, gb = (torch.load(os.path.join(out, d, "start_grids.pt")) for d in devices)
    print(f"pair: the initial SMPL grids, baked on each device, max |gap|: "
          f"{ {k: float((ga[k] - gb[k]).abs().max()) for k in ga} }", flush=True)
    print(f"pair: the scene the card alone would make, against the CPU's: {a['scene_gap'] or b['scene_gap']}")
    parting = first_parting([tuple(e) for e in a["events"]], [tuple(e) for e in b["events"]])
    print(f"pair: first parting choice: {parting}", flush=True)
    jax_rows = {r[0]: r for r in read_runlog(os.path.join(ROOT, "RUNLOG_CORRUPT.md"))}
    gaps = {}
    print("epoch | gt IoU card / CPU / JAX | PSNR card / CPU / JAX | rmse cm card / CPU / JAX | certain card / CPU | "
          "max |param| gap card-CPU (leaf)", flush=True)
    for ra, rb in zip(a["rows"], b["rows"]):
        e = ra["epoch"]
        sa = torch.load(os.path.join(out, devices[0], f"state_{e:05d}.pt"), weights_only=False)
        sb = torch.load(os.path.join(out, devices[1], f"state_{e:05d}.pt"), weights_only=False)
        leaf_gaps = {k: float((sa["params"][k] - sb["params"][k]).abs().max()) for k in sa["params"]}
        worst = max(leaf_gaps, key=leaf_gaps.get)
        gaps[e] = leaf_gaps[worst]
        j = jax_rows.get(e, (e, float("nan"), float("nan"), float("nan")))
        print(f"{e} | {ra['gt_iou']:.3f} / {rb['gt_iou']:.3f} / {j[2]:.3f} | {ra['psnr']:.2f} / {rb['psnr']:.2f} / "
              f"{j[1]:.2f} | {ra['transl_rmse_cm']:.2f} / {rb['transl_rmse_cm']:.2f} / {j[3]:.2f} | "
              f"{ra['certain']} / {rb['certain']} | {gaps[e]:.3g} ({worst})", flush=True)
    for name, run in zip(devices, (a, b)):
        if "final" in run:
            print(f"pair: {name} final opt_depth {run['final']}")
    return {"epochs": [r["epoch"] for r in a["rows"]], "parting": parting, "gaps": gaps, "same_start": same_start}


def pair(out: str, init: str, argv: list) -> None:
    """Both runs at once (the CPU run with the host's other threads), then
    `pair-table` and `pair-check` at the segments around the parting."""
    import subprocess

    threads = max(1, (os.cpu_count() or 2) - 2)
    procs = []
    for d, env in (("cuda", {"OMP_NUM_THREADS": "2"}), ("cpu", {"OMP_NUM_THREADS": str(threads)})):
        os.makedirs(os.path.join(out, d), exist_ok=True)
        log = open(os.path.join(out, d, "log.txt"), "w")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "pair-run", d, os.path.join(out, d),
                                       init, *argv], stdout=log, stderr=subprocess.STDOUT, env={**os.environ, **env}))
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"pair: the runs ended with {codes} (logs under {out}/<device>/log.txt)")
    table = pair_table(out)
    part = table["parting"][0] if table["parting"] else None
    agree = [e for e in table["epochs"] if part is None or e <= part]
    parted = [e for e in table["epochs"] if part is not None and e > part]
    pair_check(out, ([agree[-1]] if agree else []) + parted[:1], argv)


def pair_check(out: str, epochs: list, argv: list) -> None:
    """`one_state.compare_devices` on the card and the CPU from the card
    run's state at each of `epochs` (OUT/cuda/state_<epoch>.pt); the gaps go
    to OUT/one_state_<epoch>.json."""
    import json

    import torch

    from multiply_tpu_torch.data.synthetic import make_scene
    from multiply_tpu_torch.examples import longrun_synthetic, one_state

    args = longrun_synthetic.parse_args([a for a in argv if a != "--no_final_pass"])
    conf = longrun_synthetic.build_conf(args)
    train = conf.dataset.train
    scene = make_scene(num_frames=train.end_frame, num_persons=2, height=train.height, width=train.width, device="cpu")
    if args.corrupt_masks:
        scene = scene._replace(sam_logits=longrun_synthetic.corrupt_sam_logits(scene, None))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for e in epochs:
        state = torch.load(os.path.join(out, "cuda", f"state_{e:05d}.pt"), weights_only=False)
        gaps = one_state.compare_devices(conf, scene, state, ("cuda", "cpu"), os.path.join(out, f"one_state_{e:05d}"))
        with open(os.path.join(out, f"one_state_{e:05d}.json"), "w") as f:
            json.dump(gaps, f)
        print(f"pair: one state, the card's at epoch {e}: {one_state.summary(gaps)}", flush=True)
        print(f"pair: beyond tolerance at epoch {e}: {one_state.problems(gaps)}", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "export":
        np.savez(sys.argv[2], **jax_init(int(sys.argv[3]) if len(sys.argv) > 3 else 42))
    elif sys.argv[1] == "jax":
        run_jax(int(sys.argv[2]), sys.argv[3:])
    elif sys.argv[1] == "table":
        table(sys.argv[2:])
    elif sys.argv[1] == "pair":
        pair(sys.argv[2], sys.argv[3], sys.argv[4:])
    elif sys.argv[1] == "pair-run":
        pair_run(sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5:])
    elif sys.argv[1] == "pair-table":
        pair_table(sys.argv[2], tuple(sys.argv[3:]) or ("cuda", "cpu"))
    elif sys.argv[1] == "pair-check":
        cut = sys.argv.index("--")
        pair_check(sys.argv[2], [int(e) for e in sys.argv[3:cut]], sys.argv[cut + 1:])
    elif sys.argv[1] == "sweep":
        cut = sys.argv.index("--")
        sweep(int(sys.argv[2]), sys.argv[3], sys.argv[4:cut], sys.argv[cut + 1:])
    else:
        res = run(sys.argv[2], sys.argv[3:])
        print(f"final opt_depth: PSNR {res['psnr_before']:.2f} -> {res['psnr_after']:.2f} dB, max |dtransl| "
              f"{res['transl_delta']:.5f}", flush=True)
