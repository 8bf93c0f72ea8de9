"""The readings that the check's limits are set from (not part of a
benchmark run).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--faults 3] [--pretraining 1] [--seconds 0]

For each seed, in one process: the cell's set-up (the program's first steps,
as a run takes them), a window of `--seconds` (one step at 0) and the three
steps past it, then
  * `sound`: the program against the f32 reference (the run's own numbers);
  * `free`: the program against the f32 reference run on from each triple's
    first state instead of from the program's state before each step;
  * `control`: the reference in TF32 (matmuls on the tensor cores' 10-bit
    mantissa) put in the program's place, against the f32 reference;
and on the first `--faults` seeds the faults planted in the reference put
in the program's place:
  * `half_batch`: every step on the first half of its rays, the mean over them;
  * `altered`: each batch's colours +0.05, each pose mesh 5% larger;
  * `smpl_init_unchanged`: the SDF networks as initialised, not pretrained.
(A state left unchanged reads 1 by `change_gap`'s measure and needs no run.)
With `--pretraining 1`, on the first seed, other pretrainings in the
program's place (`pretraining_control`).
One JSON line a seed. On the CPU the TF32 rounding is emulated
(`tf32_emulation`), for the tests.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties away); the
    gradient passes through as it does through the card's rounding."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    bits = x.detach().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach())


class tf32_emulation(TorchFunctionMode):
    """Rounds the operands of every matrix product to TF32, as the card's
    tensor cores do with `allow_tf32`."""

    OPS = {torch.matmul, torch.Tensor.__matmul__, torch.bmm, torch.mm, torch.nn.functional.linear, torch.einsum}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            args = tuple(to_tf32(a) if torch.is_tensor(a) else a for a in args)
        return func(*args, **kwargs)


def reference_readings(records: dict, device, faults: bool) -> dict:
    """The sound, control and fault numbers of one run's captures."""
    from benchmark import check as ck
    from benchmark.reference.config import Config
    from benchmark.reference.networks import ImplicitNet

    conf, prog, scene = Config(records["conf"]), records["prog"], records["scene"]
    sound, read = ck.check(conf, scene, records["body_dir"], prog, records["sam_logits"], device)
    ref = read["ref"]
    out = {"sound": sound, "sound_parts": read["parts"]}
    free = ck.run_reference(conf, scene, records["body_dir"], prog, device, follow=False)
    parts = {p: ck.compare(ck.program_view(prog[p]), free[p]) for p in ("start", "after")}
    out["free"] = dict(ck.combine(parts), parts=parts)

    def as_program(prog_variant, tf32=False):
        if torch.device(device).type == "cpu" and tf32:
            with tf32_emulation():
                run = ck.run_reference(conf, scene, records["body_dir"], prog_variant, device)
        else:
            run = ck.run_reference(conf, scene, records["body_dir"], prog_variant, device, matmul_tf32=tf32)
        parts = {}
        for p in ("start", "after"):
            keys = list(ck.program_view(prog[p])["g0"])
            parts[p] = ck.compare(ck.reference_view(run[p], keys), ref[p])
        nums = ck.combine(parts)
        if run["start"]["mesh_gap"] is not None:
            nums["mesh_gap"] = max(run[p]["mesh_gap"] for p in ("start", "after"))
        return dict(nums, parts=parts)

    out["control"] = as_program(prog, tf32=True)
    if faults:
        half = copy.deepcopy(prog)
        for p in ("start", "after"):
            for cap in half[p]["caps"]:
                b, n = cap["batch"], cap["batch"]["uv"].shape[0] // 2
                b["uv"], b["rgb"] = b["uv"][:n], b["rgb"][:n]
                if b["sam_mask"] is not None:
                    b["sam_mask"] = b["sam_mask"][:n]
        out["half_batch"] = as_program(half)
        altered = copy.deepcopy(prog)
        for p in ("start", "after"):
            for cap in altered[p]["caps"]:
                cap["batch"]["rgb"] = cap["batch"]["rgb"] + 0.05
                if cap.get("pose_batch") is not None:
                    cap["pose_batch"]["verts_c"] = cap["pose_batch"]["verts_c"] * 1.05
        caps = altered["start"]["caps"][:3] + altered["after"]["caps"][:3]
        out["altered"] = {"batch_gap": max(ck.judge_batch(c, scene, records["sam_logits"]) for c in caps)}
        if "mesh_gap" in sound:
            out["altered"]["mesh_gap"] = as_program(altered)["mesh_gap"]
        fresh = ImplicitNet.from_config(conf.model.implicit_network, stack=len(ref["servers"]), device=device,
                                        generator=torch.Generator(device).manual_seed(0))
        init = {ck.FG_PREFIX + n: p.detach() for n, p in fresh.named_parameters()}
        out["smpl_init_unchanged"] = {"smpl_init_gap": ck.smpl_init_gap(conf, init, ref["servers"], device)}
    return out


def pretraining_control(records: dict, device) -> dict:
    """`smpl_init_gap` of other pretrainings put in the program's place: the
    reference's in TF32, cut to half its steps, and in f32 from initial
    weights moved by one rounding unit (`ulp_<k>`, leaf k), which shows how
    far rounding alone carries the weights and the fit."""
    from benchmark import check as ck
    from benchmark.reference import smpl_init
    from benchmark.reference.config import Config
    from benchmark.reference.networks import ImplicitNet

    conf = Config(records["conf"])
    model = conf.model
    _, _, _, servers = ck.reference_state(conf, records["scene"], records["body_dir"], device)
    steps = int(model.get("smpl_init_steps", 2000))
    ref = ck.pretrained_fg(conf, servers, device)
    out = {}
    for name, tf32, n, ulp in (("tf32", True, steps, None), ("half_steps", False, steps // 2, None),
                               ("ulp_0", False, steps, 0), ("ulp_3", False, steps, 3)):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            net = ImplicitNet.from_config(model.implicit_network, device=device,
                                          generator=torch.Generator(device).manual_seed(0))
            if ulp is not None:
                with torch.no_grad():
                    leaf = list(net.parameters())[ulp]
                    leaf.copy_(torch.nextafter(leaf, torch.full_like(leaf, float("inf"))))
            w = smpl_init.pretrain(net, servers[0], steps=n)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        stacked = {ck.FG_PREFIX + k: v[None].expand((len(servers),) + v.shape) for k, v in w.items()}
        out[name] = {"smpl_init_gap": ck.smpl_init_gap(conf, stacked, servers, device),
                     "weight_gap": max(float((ref[k] - v).abs().max()) for k, v in w.items())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--faults", type=int, default=3, help="plant the faults on the first N seeds")
    ap.add_argument("--pretraining", type=int, default=0, help="1: the pretraining's control on the first seed")
    ap.add_argument("--seconds", type=float, default=0.0, help="the window before the triple past it")
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "benchmark"):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from benchmark import harness, run

    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    bench = run.load_bench()
    cell, _, config, traffic = run.cell_parts(bench, args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        records = harness.run_cell(cell, config, traffic, seed, args.seconds, False, "cuda", t0)
        try:
            out = reference_readings(records, "cuda", i < args.faults)
            if i == 0 and args.pretraining:
                out["pretraining"] = pretraining_control(records, "cuda")
        finally:
            shutil.rmtree(records["workdir"], ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "setup_s": records["setup_s"],
                          "window_steps": records["steps"],
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
        del records
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
