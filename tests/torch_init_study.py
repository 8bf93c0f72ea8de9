"""How much the corrupted long run's outcome owes to the initial weights and
to the trainer's seed, in the port and in the JAX package.

Not a test (pytest collects nothing here); five commands:

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


if __name__ == "__main__":
    if sys.argv[1] == "export":
        np.savez(sys.argv[2], **jax_init(int(sys.argv[3]) if len(sys.argv) > 3 else 42))
    elif sys.argv[1] == "jax":
        run_jax(int(sys.argv[2]), sys.argv[3:])
    elif sys.argv[1] == "table":
        table(sys.argv[2:])
    elif sys.argv[1] == "sweep":
        cut = sys.argv.index("--")
        sweep(int(sys.argv[2]), sys.argv[3], sys.argv[4:cut], sys.argv[cut + 1:])
    else:
        res = run(sys.argv[2], sys.argv[3:])
        print(f"final opt_depth: PSNR {res['psnr_before']:.2f} -> {res['psnr_after']:.2f} dB, max |dtransl| "
              f"{res['transl_delta']:.5f}", flush=True)
