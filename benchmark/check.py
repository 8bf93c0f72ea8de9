"""The comparison that decides `correct`: the plain reference (`reference/`)
follows two triples of the program's training steps, taken through the same
trainer call and feed that the window drives, and the numbers below are held
to the cell's limits (`limits/<cell>.json`, which names the numbers compared).

  start  set-up's first three steps. The reference takes the first from its
         own state (every network weight drawn from the seed on the device,
         as the program draws them, the body tables, SMPL servers and
         deformers, the canonical grids baked again, the step's noise from
         the trainer's seed), but for the SDF networks that `smpl_init`
         pretrained, which it takes from the program and judges apart.
  after  three steps past the window, in an epoch of the window's kind. The
         reference cannot retrace the window's hundreds of steps.

The reference takes every step but the start's first from the program's
state before that step (parameters, both Adams' moments and counts, the
step-noise generator), so that each step is judged on its own: from one
state, a rounding apart in a step's update can flip a discrete choice of the
next step's forward (a sampler's bisection, a nearest-vertex tie) and part
two runs of sound code by as much as a TF32 control parts (PERF.md, section
6). The start and the steps that the window repeats are judged by the start
triple's first step. Such a flip can part even one step's forward from the
program's own state (a sum in another order), so the loss is compared at
each triple's first step; the later steps' stay in `loss_steps`.

What it takes from the program, and judges apart:
  * the pretrained SDF networks: `smpl_init_gap` holds their fit of the
    canonical body to the fit of the reference's own pretraining
    (`reference/smpl_init.py`, cached beside the program's under the same
    key). 2,000 Adam steps carry a difference of rounding to ~0.07 in a
    weight, so the steps cannot start from the reference's own weights;
  * each step's batch, which the producer thread built from the directory
    and the epoch-0 mask and SAM files: `batch_gap` holds its colours and SAM
    values to the image and the SAM file read again at its pixels, and its
    camera to the directory's;
  * in pose-only steps, the producer's canonical meshes: `mesh_gap` holds
    their vertices to the reference's SDF at the triple's first parameters.

The numbers (each a relative gap unless it says otherwise; a triple's
numbers are the larger of its two):
  init_gap       largest |difference| between the seeded weights and body
                 tables the program started from and the reference's;
  smpl_init_gap  |mean |SDF - exact distance| of the program's pretrained
                 network over the reference's - 1| near the canonical body,
                 the worst person;
  loss_gap       the first step's largest gap of the loss and of each
                 logged term, over the reference's |loss|;
  grad_gap       per leaf, | |g_program| - |g_reference| | of the first
                 step's gradient, each worked out from its Adam's first
                 moment before and after the step, over the larger of the
                 leaf's reference norm and the median leaf's; the median leaf;
  grad_gap_worst the same, the worst leaf;
  change_gap     the same of each leaf's change over the three steps, as
                 the fourth step finds it, against the sum of the
                 reference's three updates, for the median leaf; leaves whose
                 reference gradient stays under a thousandth of the median
                 leaf's are left out;
  batch_gap      largest |difference| of a batch value from its re-read;
  mesh_gap       mean |reference SDF| at the pose meshes' vertices, in
                 scene units.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .reference.cameras import load_K_Rt_from_P
from .reference.config import Config
from .reference.loss import LossConfig
from .reference.mesh_ops import signed_distance
from .reference.networks import ImplicitNet
from .reference.optim import AdamState
from .reference.params import BodyParamTable
from .reference.renderer import MultiplyRenderer
from .reference.server import SMPLServer
from .reference.smpl import load_smpl_model
from .reference.smpl_init import get_or_pretrain
from .reference.train import MODE_POSE_ONLY, Batch, PoseLossBatch, TrainStep

FG_PREFIX = "net.fg_implicit."
B1 = 0.9  # Adam's first-moment decay: after one step the moment is (1 - B1) x the gradient


def bilinear(img: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Bilinear interpolation of (H, W, C) at float (row, col), the corner
    cell clamped as the data layer clamps it."""
    H, W = img.shape[:2]
    r0 = np.clip(np.floor(rows).astype(np.int64), 0, H - 2)
    c0 = np.clip(np.floor(cols).astype(np.int64), 0, W - 2)
    fr, fc = (rows - r0)[:, None], (cols - c0)[:, None]
    return (img[r0, c0] * (1 - fr) * (1 - fc) + img[r0, c0 + 1] * (1 - fr) * fc
            + img[r0 + 1, c0] * fr * (1 - fc) + img[r0 + 1, c0 + 1] * fr * fc)


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Per leaf, | |a| - |b| | over max(|b|, median |b|)."""
    keys = list(keys)
    ref_n = {k: float(ref[k].norm()) for k in keys}
    median = float(np.median(list(ref_n.values()))) if keys else 0.0
    return {k: abs(float(prog[k].norm()) - ref_n[k]) / max(ref_n[k], median, 1e-30) for k in keys}


def worst(gaps: dict) -> tuple[float, str]:
    return max(((v, k) for k, v in gaps.items()), default=(0.0, ""))


def judge_batch(cap: dict, scene: dict, sam_logits: np.ndarray | None) -> float:
    """Largest gap of one captured batch from the directory read again."""
    b = cap["batch"]
    frame = int(b["frame_idx"])
    uv = b["uv"].double().numpy()
    rows, cols = uv[:, 1], uv[:, 0]
    rgb = bilinear(scene["images"][frame].astype(np.float32) / 255.0, rows, cols)
    gaps = [np.abs(rgb - b["rgb"].numpy()).max()]
    intr, pose = load_K_Rt_from_P(scene["P"].astype(np.float32)[:3, :4])
    gaps.append(np.abs(intr[:3, :3] - b["intrinsics"].numpy()).max())
    gaps.append(np.abs(pose - b["pose"].numpy()).max())
    gaps.append(np.abs(b["smpl_scale"].numpy() - 1.0).max())
    if sam_logits is not None:
        sam = bilinear(sam_logits[frame], rows, cols)
        gaps.append(np.abs(sam - b["sam_mask"].numpy()).max() / 16.0)  # logits span +-8
    pb = cap.get("pose_batch")
    if pb is not None and sam_logits is not None:
        px = pb["uv"].numpy().astype(np.int64)
        probs = 1.0 / (1.0 + np.exp(-sam_logits[frame][px[:, 1], px[:, 0]]))
        gaps.append(np.abs(probs - pb["sam_probs"].numpy()).max())
    return float(max(gaps))


def reference_state(conf: Config, scene: dict, body_dir: str, device):
    """(renderer, builder, body table) as the reference builds them from the
    configuration, the seed and the directory's arrays."""
    model_conf = conf.model
    P, F = scene["betas"].shape[0], scene["poses"].shape[0]
    seed = int(conf.seed)
    renderer = MultiplyRenderer(model_conf, num_persons=P, num_frames=F,
                                generator=torch.Generator(device).manual_seed(seed), device=device)
    servers = [SMPLServer.create(load_smpl_model(body_dir, "neutral", device=device), betas=scene["betas"][p])
               for p in range(P)]
    state = renderer.build_person_state(servers, grid_res=int(model_conf.get("cano_grid_res", 64)))
    builder = TrainStep(renderer, state, LossConfig.from_config(model_conf.loss),
                        learning_rate=model_conf.learning_rate, sched_milestones=tuple(model_conf.sched_milestones),
                        sched_factor=model_conf.sched_factor, interp_samples=int(model_conf.get("interp_samples", 5120)))
    tables = [BodyParamTable.create(F, betas=scene["betas"][p], global_orient=scene["poses"][:, p, :3],
                                    transl=scene["transl"][:, p], body_pose=scene["poses"][:, p, 3:], device=device)
              for p in range(P)]
    return renderer, builder, BodyParamTable.stack(tables), servers


def pretrained_fg(conf: Config, servers: list, device) -> dict:
    """The SDF network's weights by name as the reference's `smpl_init` makes
    them on the first person's canonical body (every person is neutral); {}
    where the configuration has no `smpl_init`."""
    model = conf.model
    if not model.get("smpl_init", False):
        return {}
    cache = os.path.join(model.smpl_init_cache_dir, "reference_smpl_init_neutral.npz")
    return get_or_pretrain(model.implicit_network, servers[0], cache, int(model.get("smpl_init_steps", 2000)), device)


def fit_error(conf: Config, weights: dict, server, device, n: int = 20_000) -> float:
    """Mean |SDF - exact signed distance| of one SDF network (weights by
    name, zero pose conditioning) on points drawn near the canonical body."""
    rng = np.random.default_rng(0)
    verts = server.verts_c
    idx = torch.as_tensor(rng.integers(0, verts.shape[0], n), device=device)
    pts = verts[idx] + torch.as_tensor(rng.normal(0.0, 0.05, (n, 3)), dtype=torch.float32, device=device)
    net = ImplicitNet.from_config(conf.model.implicit_network, device=device)
    with torch.no_grad():
        for name, param in net.named_parameters():
            param.copy_(weights[name])
        exact = signed_distance(pts, verts, server.model.faces)
        return float((net(pts, torch.zeros(69, device=device))[:, 0] - exact).abs().mean())


def smpl_init_gap(conf: Config, params0: dict, servers: list, device) -> float:
    """How far the fit of each person's SDF network that the program started
    from parts from the fit of the reference's own pretraining: |fit error /
    the reference's - 1|, the worst person. Weights are not compared: 2,000
    Adam steps carry a rounding difference to ~0.07 in a weight, the fit
    they reach stays the same."""
    ref = pretrained_fg(conf, servers, device)
    if not ref:
        return 0.0
    ref_err = fit_error(conf, ref, servers[0], device)
    gap = 0.0
    for p in range(len(servers)):
        prog = {k[len(FG_PREFIX):]: v[p].to(device) for k, v in params0.items() if k.startswith(FG_PREFIX)}
        gap = max(gap, abs(fit_error(conf, prog, servers[0], device) / ref_err - 1.0))
    return gap


def mesh_gap(renderer: MultiplyRenderer, body: BodyParamTable, caps: list) -> float:
    """Mean |SDF| of the reference, at the parameters it holds, at each pose
    batch's mesh vertices (the producer meshes an epoch-start snapshot)."""
    worst = 0.0
    for cap in caps:
        pb, frame = cap.get("pose_batch"), int(cap["batch"]["frame_idx"])
        if pb is None:
            continue
        verts = pb["verts_c"].to(body.betas.device)
        cond = body.body_pose[:, frame].detach() / math.pi
        with torch.no_grad():
            sdf = renderer._implicit(verts, cond, body.betas[:, 0].detach())[..., 0]
        worst = max(worst, float(sdf.abs().mean()))
    return worst


def batch_from(cap: dict, device) -> tuple[Batch, PoseLossBatch | None]:
    b = {k: v.to(device) if torch.is_tensor(v) else v for k, v in cap["batch"].items()}
    batch = Batch(**b)
    pb = cap.get("pose_batch")
    if pb is not None:
        pb = PoseLossBatch(**{k: v.to(device) if torch.is_tensor(v) else v for k, v in pb.items()})
    return batch, pb


def opt_name(mode: int) -> str:
    return "opt_pose" if mode == MODE_POSE_ONLY else "opt_joint"


def first_grad(mu1: dict, mu0: dict) -> dict:
    """The first step's gradient as its Adam's first moment records it."""
    return {k: (m.double() - B1 * mu0[k].cpu().double()) / (1.0 - B1) for k, m in mu1.items()}


def load_program_state(ts, part: dict, i: int, gen, device) -> None:
    """The program's parameters, both Adams' state and the step-noise
    generator as they were before the part's step i + 1."""
    with torch.no_grad():
        for k, p in ts.params().items():
            p.copy_(part[f"params{i}"][k].to(device))
    for w in ("opt_joint", "opt_pose"):
        st = part[f"opt{i}"][w]
        setattr(ts, w, AdamState(mu={k: v.to(device) for k, v in st["mu"].items()},
                                 nu={k: v.to(device) for k, v in st["nu"].items()}, count=dict(st["count"])))
    gen.set_state(part[f"gen{i}"])


def run_reference(conf: Config, scene: dict, body_dir: str, prog: dict, device, matmul_tf32: bool = False,
                  follow: bool = True) -> dict:
    """The reference's run of both triples from the captured batches: its
    initial weights, and per triple the logs, the first gradient, each
    step's gradient norms, the changes over the three steps and `mesh_gap`.
    `follow`: each step but the start's first from the program's state
    before it (the check); otherwise each triple runs on from its first
    step's state (`control.py` reads it, to show how far steps that run on
    part)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = matmul_tf32
    try:
        renderer, builder, body, servers = reference_state(conf, scene, body_dir, device)
        ts = builder.init_state(body)
        out = {"init": {k: v.detach().cpu().clone() for k, v in ts.params().items() if not k.startswith(FG_PREFIX)}}
        for name in ("start", "after"):
            part = prog[name]
            caps = part["caps"]
            mode = int(caps[0]["batch"]["mode"])
            gen = torch.Generator(device)
            if name == "start":  # the SDF networks as the program's `smpl_init` left them
                with torch.no_grad():
                    for k, p in ts.params().items():
                        if k.startswith(FG_PREFIX):
                            p.copy_(part["params0"][k].to(device))
                gen.manual_seed(int(conf.seed))
            res = {"mesh_gap": None}
            change = {k: torch.zeros_like(p) for k, p in ts.params().items()}
            logs_all, grad_norms = [], []
            for i, cap in enumerate(caps[:3]):
                if (follow and i > 0) or (name == "after" and i == 0):
                    load_program_state(ts, part, i, gen, device)
                if i == 0:
                    if mode == MODE_POSE_ONLY:
                        res["mesh_gap"] = mesh_gap(renderer, body, caps[:3])
                    mu0 = {k: v.clone() for k, v in getattr(ts, opt_name(mode)).mu.items()}
                ts.epoch = int(cap["epoch"])
                before = {k: p.detach().clone() for k, p in ts.params().items()}
                batch, pose_batch = batch_from(cap, device)
                noise = builder.draw_noise(batch, pose_batch, gen)
                loss, logs, grads = builder.loss_and_grads(ts, batch, noise=noise, pose_batch=pose_batch)
                ts, logs = builder.update(ts, batch.mode, loss, logs, grads)
                logs_all.append({k: float(v) for k, v in logs.items()})
                grad_norms.append({k: float(g.norm()) for k, g in grads.items()})
                for k, p in ts.params().items():
                    change[k] += p.detach() - before[k]
                if i == 0:
                    res["g0"] = first_grad({k: v.cpu() for k, v in getattr(ts, opt_name(mode)).mu.items()}, mu0)
            res.update(logs=logs_all, grad_norms=grad_norms, change={k: v.cpu() for k, v in change.items()})
            out[name] = res
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    out["servers"] = servers
    return out


def program_view(part: dict) -> dict:
    """The program's triple as `compare` reads it: logs, the first step's
    gradient from its Adam's first moment, each leaf's change."""
    opt = opt_name(int(part["caps"][0]["batch"]["mode"]))
    mu1 = part["opt1"][opt]["mu"]
    return {"logs": [c["logs"] for c in part["caps"][:3]], "g0": first_grad(mu1, part["opt0"][opt]["mu"]),
            "change": {k: part["params3"][k] - part["params0"][k] for k in mu1}}


def reference_view(run: dict, keys) -> dict:
    """A reference run's triple put in the program's place (the control, a planted fault)."""
    return {"logs": run["logs"], "g0": {k: run["g0"][k] for k in keys}, "change": {k: run["change"][k] for k in keys}}


def compare(view: dict, ref: dict) -> dict:
    """The numbers of a view of three steps against the f32 reference's run
    of them (see PERF.md, section 6): `loss_gap` the first step's loss and
    terms (a later step's forward can flip a discrete choice on a rounding
    apart even from the program's state, `loss_gap_3`), `grad_gap` /
    `grad_gap_worst` the first gradient's median and worst leaf,
    `change_gap` / `change_gap_worst` the change over the three steps."""
    out = {"loss_steps": []}
    for lp, lr in zip(view["logs"], ref["logs"]):
        scale = max(abs(lr["loss"]), 1e-30)
        terms = {k: abs(lp[k] - v) / scale for k, v in lr.items() if k in lp and k not in ("lr", "update_skipped")}
        out["loss_steps"].append(max(terms.values(), default=0.0))
        if len(out["loss_steps"]) == 1:
            out["loss_gap"], out["loss_term"] = worst(terms)
    out["loss_gap_3"] = max(out["loss_steps"])
    keys = list(view["g0"])
    grad = leaf_gaps(view["g0"], ref["g0"], keys)
    out["grad_gap"] = float(np.median(list(grad.values()))) if grad else 0.0
    out["grad_gap_worst"], out["grad_leaf"] = worst(grad)
    median = float(np.median([max(n[k] for n in ref["grad_norms"]) for k in keys]))
    moved = [k for k in keys if max(n[k] for n in ref["grad_norms"]) >= 1e-3 * median]
    change = leaf_gaps({k: view["change"][k] for k in moved}, {k: ref["change"][k] for k in moved}, moved)
    out["change_gap"] = float(np.median(list(change.values()))) if change else 0.0
    out["change_gap_worst"], out["change_leaf"] = worst(change)
    return out


COMPARED = ("loss_gap", "grad_gap", "grad_gap_worst", "change_gap", "change_gap_worst")


def combine(per_part: dict) -> dict:
    """Each compared number as the larger of the two triples'."""
    return {k: max(per_part[p][k] for p in per_part) for k in COMPARED}


def check(conf: Config, scene: dict, body_dir: str, prog: dict, sam_logits, device) -> tuple[dict, dict]:
    """(every number of the module docstring, what each triple read) for one run's captures."""
    ref = run_reference(conf, scene, body_dir, prog, device)
    parts = {p: compare(program_view(prog[p]), ref[p]) for p in ("start", "after")}
    nums = combine(parts)
    params0 = prog["start"]["params0"]
    nums["init_gap"] = max(float((v - params0[k]).abs().max()) for k, v in ref["init"].items())
    nums["smpl_init_gap"] = smpl_init_gap(conf, params0, ref["servers"], device)
    caps = prog["start"]["caps"][:3] + prog["after"]["caps"][:3]
    nums["batch_gap"] = max(judge_batch(c, scene, sam_logits) for c in caps)
    if ref["start"]["mesh_gap"] is not None:
        nums["mesh_gap"] = max(ref[p]["mesh_gap"] for p in ("start", "after"))
    return nums, {"ref": ref, "parts": parts}
