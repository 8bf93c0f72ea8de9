"""The ranks of tests/test_torch_parallel.py and test_torch_fit.py, in a
module without JAX: a spawned process imports the module of its target, and
the test files import JAX. `run_ranks` is the target of one process, which
runs rank 0 and spawns rank 1 (`parallel.launch`, gloo on the CPU). Inputs
come from a file the test wrote (`torch.save` of the port's objects); each
rank writes what it saw to `<out_dir>/<case>_<rank>.pt`. `stages_rank` is a
rank of the training entry's trainer across epoch 20's stages."""

from __future__ import annotations

import copy
import os

import torch

from multiply_tpu_torch.cli import train as cli_train
from multiply_tpu_torch.engine.evaluator import Evaluator
from multiply_tpu_torch.models import loss as loss_module
from multiply_tpu_torch.parallel import launch, sharded_train_step

TIMEOUT_S = 60.0


def run_ranks(inputs_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    launch(_rank, (inputs_path, out_dir), ["cpu", "cpu"], "gloo", os.path.join(out_dir, "rendezvous"),
           timeout_s=TIMEOUT_S)


def per_rank_means(share, outputs):
    """The planted fault: each rank's own means, weighted 1/W (an average of
    the ranks' means) instead of the whole batch's."""
    return torch.full((3,), 1.0 / share.world)


def _rank(group, inputs_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(inputs_path, weights_only=False)
    stepper = inp["stepper"]
    update, fractions = stepper.update, loss_module.ray_fractions
    seen: dict = {}

    def recorded_update(ts, mode, loss, logs, grads):
        seen["grads"] = {k: g.clone() for k, g in grads.items()}
        return update(ts, mode, loss, logs, grads)

    def recorded_fractions(share, outputs):
        seen["fractions"] = fractions(share, outputs)
        return seen["fractions"]

    stepper.update = recorded_update
    for case, (batch, noise, fault) in inp["cases"].items():
        loss_module.ray_fractions = per_rank_means if fault else recorded_fractions
        ts = copy.deepcopy(inp["ts"])
        ts.epoch = inp["epoch"]
        ts, logs = sharded_train_step(stepper, group)(ts, batch, noise=noise)
        torch.save({"logs": {k: float(v) for k, v in logs.items()}, "grads": seen["grads"],
                    "fractions": seen.get("fractions"),
                    "params": {k: p.detach().clone() for k, p in ts.params().items()}},
                   os.path.join(out_dir, f"{case}_{group.rank}.pt"))
    loss_module.ray_fractions = fractions

    ev = Evaluator(stepper.renderer, stepper.state, [], pixel_per_batch=inp["pixel_per_batch"], group=group)
    merged = ev.render_image(inp["ts"].body, inp["item"], epoch=100)
    torch.save({"chunk": ev.chunk, "render": merged}, os.path.join(out_dir, f"render_{group.rank}.pt"))


def stages_rank(group, args):
    """Rank 0 fits epoch 0, then epochs 20 (mesh refresh, opt_depth) with the
    entry's trainer while the other rank follows; then every rank's
    parameters and grids are gathered. Rank 0 returns (its grid moved, every
    rank's parameters and grids bitwise equal, the Adam step counts)."""
    trainer, _, ckpt_dir = cli_train.build_trainer(args, group)
    moved = None
    if group.rank == 0:
        try:
            grid = trainer.person_state.cano_grid["grid"].clone()
            trainer.fit(1, ckpt_dir=ckpt_dir)
            trainer.epoch = 20
            trainer.fit(21, ckpt_dir=ckpt_dir)
            moved = not torch.equal(grid, trainer.person_state.cano_grid["grid"])
        finally:
            trainer.release_followers()
    else:
        trainer.follow()
    mine = torch.cat([*(p.detach().reshape(-1) for p in trainer.ts.params().values()),
                      *(v.reshape(-1) for v in trainer.person_state.cano_grid.values())])
    every = group.all_gather(mine[None])
    return moved, all(torch.equal(every[0], e) for e in every), dict(trainer.ts.opt_joint.count)
