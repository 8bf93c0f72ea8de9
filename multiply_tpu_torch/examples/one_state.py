"""One state of the long run on two devices: the trainer captured at a
segment boundary, restored on the card and on the CPU, and there the step and
every epoch-end stage run once on the same inputs and random numbers.

    state = capture(trainer)                     # host copies, any device
    gaps = compare_devices(conf, scene, state, ("cuda", "cpu"), work_dir)
    problems(gaps)                               # [] when no gap passes its tolerance

Compared, from the one state: a joint step and a pose-only step (loss and
every gradient; one batch, one pose-loss payload and one noise dict, drawn on
the host), the mesh refresh (`_compute_canonical_grids`), the instance-mask
stage, the SAM stage on the same instance masks, and one opt_depth iteration
(its loss, terms and the body gradients). Inputs that the host builds (items,
meshes of the pose-loss payload, pixels) are built once, on the last device
named, and copied to the others.

`host_noise` draws a step's random numbers from a CPU `torch.Generator` and
moves them to the step's device: with it a card run and a CPU run see the
same numbers (`tests/torch_init_study.py pair`).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import types

import numpy as np
import torch

# The f32 tolerances that the CPU tests hold the port to JAX with: the trainer's step and opt_depth losses
# (tests/test_torch_trainer.py) and the pose terms (tests/test_torch_pose.py) within 1e-4 relative, each
# gradient entry as `tests/_torch_helpers.assert_step_matches` holds it
LOSS_RTOL = 1e-4  # a loss or loss term, relative (atol 1e-7)
GRAD_REL = 1e-2  # each gradient entry within this share of its leaf's largest |gradient| (atol 1e-9)
# With `sampler_bf16` the steps run twice: the sampler in f32, held to the tolerances above, and as configured,
# its loss held to the band that tests/test_torch_variant_steps.py holds a bf16-sampler step to against JAX
BF16_LOSS_BAND = 0.05  # relative, the total loss; every gradient finite
# The stages' limits, from the first card-against-CPU runs at epochs 20, 40 and 100 (PERF.md section 6:
# meshes 3.6e-5 and 5.2e-5 apart, the bakes 1.2e-7, no instance-mask pixel and no keypoint apart)
GRID_ABS = 1e-4  # a refreshed grid's values and the extracted meshes' vertices, absolute (grid spacing ~0.1)
MASK_EDGE_PIXELS = 4  # instance-mask pixels that may differ over all frames and persons, each on a mask's edge
KEYPOINT_PX = 1e-3  # projected joints, pixels
SAM_ABS = 0.0  # the SAM stage on the same instance masks: host arithmetic, equal


def capture(tr) -> dict:
    """Host copies of everything the trainer's next step and stages read: the
    parameters, both Adam states, the epoch, the canonical grids, the host
    generator, the sequence's SAM pickup and the stage files it came from."""

    def host(t):
        return t.detach().cpu().clone()

    def adam(s):
        return {"mu": {k: host(v) for k, v in s.mu.items()}, "nu": {k: host(v) for k, v in s.nu.items()},
                "count": {k: host(v) if torch.is_tensor(v) else v for k, v in s.count.items()}}

    pickup = tr.seq.sam_pickup
    files = {}
    if pickup.masks is not None:
        stage_dir = os.path.dirname(pickup.path)
        inst = os.path.join(tr.run_dir, "stage_instance_mask", os.path.basename(stage_dir))
        for rel, path in ((os.path.join("stage_sam_mask", os.path.basename(stage_dir)), stage_dir),
                          (os.path.join("stage_instance_mask", os.path.basename(stage_dir)), inst)):
            if os.path.isdir(path):
                for name in sorted(os.listdir(path)):
                    if name.endswith(".npy"):
                        files[os.path.join(rel, name)] = np.load(os.path.join(path, name))
    return {
        "epoch": tr.epoch,
        "params": {k: host(v) for k, v in tr.ts.params().items()},
        "opt_joint": adam(tr.ts.opt_joint),
        "opt_pose": adam(tr.ts.opt_pose),
        "cano_grid": {k: host(v) for k, v in tr.person_state.cano_grid.items()},
        "rng": tr.rng.bit_generator.state,
        "pickup": {"masks": pickup.masks, "iou": pickup.iou, "threshold": pickup.threshold},
        "files": files,
    }


def restore(tr, state: dict) -> None:
    """Put a captured state into a trainer built on any device."""
    from ..data.dataset import SamPickup
    from ..engine.optim import AdamState

    dev = tr.device
    with torch.no_grad():
        for k, p in tr.ts.params().items():
            p.copy_(state["params"][k])

    def adam(s):
        return AdamState(mu={k: v.to(dev) for k, v in s["mu"].items()}, nu={k: v.to(dev) for k, v in s["nu"].items()},
                         count={k: v.to(dev) if torch.is_tensor(v) else v for k, v in s["count"].items()})

    tr.ts.opt_joint, tr.ts.opt_pose = adam(state["opt_joint"]), adam(state["opt_pose"])
    tr.epoch = tr.ts.epoch = int(state["epoch"])
    tr._apply_canonical_grids({k: v.to(dev) for k, v in state["cano_grid"].items()})
    tr.rng.bit_generator.state = state["rng"]
    path = ""
    for rel, arr in state["files"].items():
        os.makedirs(os.path.join(tr.run_dir, os.path.dirname(rel)), exist_ok=True)
        np.save(os.path.join(tr.run_dir, rel), arr)
        if rel.endswith("sam_opt_mask.npy"):
            path = os.path.join(tr.run_dir, rel)
    pick = state["pickup"]
    tr.seq.sam_pickup = SamPickup(path, pick["masks"], pick["iou"], pick["threshold"])


def build_trainer(conf, scene, device, run_dir: str, segmenter: str = "color", seed: int = 0):
    """The long run's trainer (`longrun_synthetic.run`'s set-up) on `device`
    over the scene's host arrays."""
    from ..cli.train import build_servers
    from ..data.synthetic_sequence import SyntheticSequence
    from ..engine.sam_stage import ColorPromptPredictor, PriorSegmenter, SamSegmenter
    from ..engine.trainer import Trainer

    dev = torch.device(device)
    os.makedirs(run_dir, exist_ok=True)
    seq = SyntheticSequence(scene, num_sample=conf.dataset.train.num_sample, using_sam=True, run_dir=run_dir,
                            ratio_uncertain=0.5)
    servers = build_servers(conf, seq, dev)
    seg = (SamSegmenter(ColorPromptPredictor(), list(scene.images), seed=seed) if segmenter == "color"
           else PriorSegmenter())
    return Trainer(conf, seq, servers, run_dir=run_dir, segmenter=seg, device=dev)


def host_noise(builder, num_rays: int, pose_batch, generator: torch.Generator, device) -> dict:
    """`TrainStep.draw_noise`'s numbers, drawn in its order from a CPU
    generator, on `device`."""
    from ..engine.pose_losses import draw_interpenetration_samples
    from ..models.renderer import MultiplyRenderer

    r = builder.renderer
    on_host = types.SimpleNamespace(sampler_cfg=r.sampler_cfg, P=r.P, beta=torch.empty(0),
                                    smpl_surface_weight=r.smpl_surface_weight, zero_pose_weight=r.zero_pose_weight)
    logits = builder.state.surface_sample_logits
    noise = MultiplyRenderer.draw_noise(on_host, num_rays, builder.state.server.verts_c.shape[-2], generator,
                                        None if logits is None else logits.cpu())
    if pose_batch is not None:
        P, V = pose_batch.verts_c.shape[:2]
        noise["interp_idx"] = draw_interpenetration_samples([V] * P, builder.interp_samples, generator, "cpu")
    return to_device(noise, device)


def to_device(x, device):
    """Tensors (in dicts, lists and dataclasses) on `device`."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_device(getattr(x, f.name), device) for f in dataclasses.fields(x)})
    return x


def grid_sample_points(verts: np.ndarray, res: int, n: int) -> np.ndarray:
    """`n` of the points at which `sdf_grid` bakes a mesh at `res`, spread
    evenly over its raveled lattice (all of them where n >= res^3)."""
    lo, hi = verts.min(0) - 0.2, verts.max(0) + 0.2
    axes = [np.linspace(0.0, 1.0, res, dtype=np.float32) * (hi[i] - lo[i]) + lo[i] for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return pts[np.linspace(0, len(pts) - 1, min(n, len(pts))).astype(np.int64)].astype(np.float32)


def leaf_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over `want`'s largest |entry| (0 where both are 0)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    return diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-7 / LOSS_RTOL)


def step_gaps(outs: dict, ref: str) -> dict:
    """Loss terms (relative) and each gradient leaf (over its largest entry)
    of each device against `ref`'s."""
    want_logs, want_grads = outs[ref]
    res = {}
    for dev, (logs, grads) in outs.items():
        if dev == ref:
            continue
        res[dev] = {"terms": {k: rel_gap(float(v.detach()), float(want_logs[k].detach())) for k, v in logs.items()
                              if torch.is_tensor(v) and v.numel() == 1},
                    "grads": {k: leaf_gap(g, want_grads[k]) for k, g in grads.items()},
                    "finite": all(bool(torch.isfinite(g).all()) for g in (*grads.values(), *want_grads.values()))}
    return res


def mask_edge(masks: np.ndarray) -> np.ndarray:
    """Pixels of (..., H, W) bool masks that touch a pixel of the other value (4-neighbours)."""
    m = np.asarray(masks, bool)
    edge = np.zeros_like(m)
    for axis in (-1, -2):
        diff = np.diff(m, axis=axis)
        lo = [slice(None)] * m.ndim
        hi = [slice(None)] * m.ndim
        lo[axis], hi[axis] = slice(0, -1), slice(1, None)
        edge[tuple(lo)] |= diff
        edge[tuple(hi)] |= diff
    return edge


CHECKS = ("joint_step", "pose_step", "mesh_refresh", "instance_mask", "sam", "opt_depth")
# The check's own sample counts, the same on every device: the CPU takes minutes for the run's own (1024 pose
# pixels, 2048 interpenetration samples and depth pixels against 65,536 padded faces; the bake of a 44k-face mesh
# at all 13,824 points of a res-24 grid)
SIZES = {"pose_pixels": 64, "interp_samples": 64, "depth_pixels": 64, "depth_rays": 64, "grid_points": 512}


def compare_devices(conf, scene, state: dict, devices=("cuda", "cpu"), work_dir: str = "one_state",
                    frame: int = 0, seed: int = 0, checks=CHECKS, sizes=None) -> dict:
    """The step and each stage from `state` on each device (`checks`, in
    CHECKS's order; "sam" needs "instance_mask"), at `sizes` (SIZES by
    default; None values keep the run's own); gaps of each device against
    the last one's (the reference, which also builds the host inputs). The
    mesh refresh is compared in its two parts: each device's canonical
    meshes (its SDF, marching cubes on the host), and the bake of the
    reference's meshes at `grid_points` points of the grid, spread evenly.
    Returns {check: measured gaps, ...} (see `problems`)."""
    from ..body.params import BodyParamTable
    from ..data.dataset import weighted_sampling
    from ..engine.pose_losses import depth_loss_schedule
    from ..engine.train import MODE_JOINT, MODE_POSE_ONLY
    from ..engine.trainer import BODY_FIELDS, pose_batch_from_meshes
    from ..ops.mesh_ops import signed_distance

    shutil.rmtree(work_dir, ignore_errors=True)
    ref = devices[-1]
    trainers = {}
    for d in devices:
        tr = build_trainer(conf, scene, d, os.path.join(work_dir, str(d).replace(":", "")))
        restore(tr, state)
        trainers[d] = tr
    host = trainers[ref]
    sizes = {**SIZES, **(sizes or {})}
    for tr in trainers.values():
        tr.pose_pixel_samples = sizes["pose_pixels"] or tr.pose_pixel_samples
        tr.builder.interp_samples = sizes["interp_samples"] or tr.builder.interp_samples
        tr.depth_pixel_samples = sizes["depth_pixels"] or tr.depth_pixel_samples
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = {"epoch": int(state["epoch"]), "devices": list(devices)}
    bf16 = host.renderer.sampler_bf16
    precisions = (("", False), ("_bf16", True)) if bf16 else (("", False),)

    def stepped(name, run):
        """`run()` -> {device: (logs, grads)} with the sampler in f32, and as
        configured where that is bfloat16 (`name`_bf16)."""
        for suffix, sampler_bf16 in precisions:
            for tr in trainers.values():
                tr.renderer.sampler_bf16 = sampler_bf16
            outs = run()
            sync()
            out[name + suffix] = step_gaps(outs, ref)
            out[name + suffix]["loss"] = {d: float(o[0]["loss"]) for d, o in outs.items()}
        for tr in trainers.values():
            tr.renderer.sampler_bf16 = bf16

    def sync():
        if any(torch.device(d).type == "cuda" for d in devices):
            torch.cuda.synchronize()

    # ---- a joint step and a pose-only step ----
    item = host.seq.get_train_item(frame, rng)
    for name, mode in (("joint_step", MODE_JOINT), ("pose_step", MODE_POSE_ONLY)):
        if name not in checks:
            continue
        batch = host.make_batch(item, mode)
        pose_batch = (host.pose_loss_batch(frame, rng, params=host._params_snapshot()) if mode == MODE_POSE_ONLY
                      else None)
        if mode == MODE_POSE_ONLY and pose_batch is None:
            out[name] = {"skipped": "no SAM masks in the state"}
            continue
        noise = host_noise(host.builder, batch.uv.shape[0], pose_batch, gen, "cpu")

        def run(batch=batch, pose_batch=pose_batch, noise=noise):
            outs = {}
            for d, tr in trainers.items():
                loss, logs, grads = tr.builder.loss_and_grads(
                    tr.ts, to_device(batch, tr.device), noise=to_device(noise, tr.device),
                    pose_batch=to_device(pose_batch, tr.device))
                outs[d] = ({**logs, "loss": loss.detach()}, grads)
            return outs

        stepped(name, run)

    # ---- the mesh refresh: each device's canonical meshes, then the bake of the reference's ----
    if "mesh_refresh" in checks:
        meshes = {d: [tr._canonical_mesh(p, params=tr._params_snapshot()) for p in range(tr.num_person)]
                  for d, tr in trainers.items()}
        res = {}
        for d, tr in trainers.items():
            if d == ref:
                continue
            same = all(len(v) == len(rv) and np.array_equal(f, rf) for (v, f), (rv, rf) in zip(meshes[d], meshes[ref]))
            vert_gap = max(float(np.abs(v - rv).max()) for (v, _), (rv, _) in zip(meshes[d], meshes[ref])) if same \
                else float("inf")
            bake_gap = 0.0
            for rv, rf in meshes[ref]:
                pts = grid_sample_points(rv, tr.grid_res, sizes["grid_points"])
                vals = {}
                for dd in (d, ref):
                    dev = trainers[dd].device
                    vals[dd] = signed_distance(torch.as_tensor(pts, device=dev), torch.as_tensor(rv, device=dev),
                                               torch.as_tensor(rf, device=dev)).cpu().double()
                bake_gap = max(bake_gap, float((vals[d] - vals[ref]).abs().max()))
            res[d] = {"same_faces": same, "vertex_gap": vert_gap, "bake_gap": bake_gap,
                      "faces": [len(f) for _, f in meshes[d]], "faces_ref": [len(f) for _, f in meshes[ref]]}
        sync()
        out["mesh_refresh"] = res

    # ---- the instance-mask stage, then the SAM stage on the reference's instance masks ----
    if "instance_mask" in checks:
        ep = int(state["epoch"])
        rel = os.path.join("stage_instance_mask", f"{ep:05d}")
        for tr in trainers.values():
            tr.instance_mask_stage(epoch=ep)
        sync()
        inst = {d: {n: np.load(os.path.join(tr.run_dir, rel, n)) for n in ("all_person_smpl_mask.npy", "2d_keypoint.npy")}
                for d, tr in trainers.items()}
        want = inst[ref]["all_person_smpl_mask.npy"]
        edge = mask_edge(want)
        res = {}
        for d, got in inst.items():
            if d == ref:
                continue
            differ = got["all_person_smpl_mask.npy"] != want
            res[d] = {"pixels": int(differ.sum()), "off_edge": int((differ & ~edge).sum()),
                      "keypoint_px": float(np.abs(got["2d_keypoint.npy"] - inst[ref]["2d_keypoint.npy"]).max())}
            shutil.rmtree(os.path.join(trainers[d].run_dir, rel))
            shutil.copytree(os.path.join(host.run_dir, rel), os.path.join(trainers[d].run_dir, rel))
        out["instance_mask"] = res
    if "sam" in checks:
        sams = {}
        for d, tr in trainers.items():
            tr.sam_stage(epoch=ep)
            sams[d] = np.load(os.path.join(tr.run_dir, "stage_sam_mask", f"{ep:05d}", "sam_opt_mask.npy"))
        out["sam"] = {d: {"abs": float(np.abs(s - sams[ref]).max())} for d, s in sams.items() if d != ref}

    # ---- one opt_depth iteration (`_opt_depth_frame`'s first) ----
    sam = host.seq._sam_masks
    if "opt_depth" in checks and sam is None:
        out["opt_depth"] = {"skipped": "no SAM masks in the state"}
    elif "opt_depth" in checks:
        ev = host.seq.get_eval_item(frame)
        H, W = ev["img_size"]
        probs = 1.0 / (1.0 + np.exp(-sam[frame]))
        params = host._params_snapshot()
        meshes = [host._canonical_mesh(p, params["body.body_pose"][p, frame].cpu().numpy() / np.pi, params=params)
                  for p in range(host.num_person)]
        vy, vx = np.nonzero((probs.sum(-1) >= 0.7) & (probs.sum(-1) <= 1.01))
        M = min(host.depth_pixel_samples, len(vx))
        sel = rng.choice(len(vx), M, replace=False)
        uv = np.stack([vx[sel], vy[sel]], -1).astype(np.float32)
        pose_batch = pose_batch_from_meshes(meshes, uv, probs[vy[sel], vx[sel]], len(vx) / M, host.mesh_pad_bucket,
                                            "cpu")
        frame_data = host.seq.load_frame(frame)
        samples, _ = weighted_sampling({"rgb": frame_data["img"], "uv": frame_data["uv"],
                                        "object_mask": frame_data["mask_union"], "sam_mask": sam[frame]},
                                       (H, W), sizes["depth_rays"] or int(conf.model.get("depth_render_rays", 512)), rng)
        batch = host.make_batch({"uv": samples["uv"], "rgb": samples["rgb"], "sam_mask": samples["sam_mask"],
                                 "pose": ev["pose"], "intrinsics": ev["intrinsics"], "idx": frame,
                                 "smpl_scale": np.full(host.num_person, host.seq.scale, np.float32)}, MODE_JOINT)
        noise = host_noise(host.builder, batch.uv.shape[0], pose_batch, gen, "cpu")

        def run():
            outs = {}
            for d, tr in trainers.items():
                body = BodyParamTable(*(getattr(tr.ts.body, f).detach().clone() for f in BODY_FIELDS))
                bp = dict(body.named_parameters())
                val, parts = tr._depth_loss(body, to_device(batch, tr.device), to_device(pose_batch, tr.device),
                                            to_device(noise, tr.device), depth_loss_schedule(1.0, tr.epoch))
                grads = dict(zip(bp, torch.autograd.grad(val, list(bp.values()))))
                outs[d] = ({"loss": val.detach(), **{k: v.detach() for k, v in parts.items()}}, grads)
            return outs

        stepped("opt_depth", run)
    return out


def problems(gaps: dict) -> list:
    """Each gap of `compare_devices`'s result beyond its tolerance, as text
    (a check skipped for want of SAM masks is not a gap: `summary` names it)."""
    found = []
    for name in ("joint_step_bf16", "pose_step_bf16", "opt_depth_bf16"):
        for d, g in gaps.get(name, {}).items():
            if d == "loss":
                continue
            if not g["terms"]["loss"] <= BF16_LOSS_BAND:
                found.append(f"{name} on {d}: the loss {g['terms']['loss']:.3g} apart (relative), over {BF16_LOSS_BAND}")
            found += [] if g["finite"] else [f"{name} on {d}: a gradient is not finite"]
    for name in ("joint_step", "pose_step", "opt_depth"):
        for d, g in gaps.get(name, {}).items():
            if d in ("loss", "skipped"):
                continue
            found += [f"{name} on {d}: {k} {v:.3g} apart (relative), over {LOSS_RTOL}"
                      for k, v in g["terms"].items() if v > LOSS_RTOL]
            found += [f"{name} on {d}: gradient {k} {v:.3g} of its largest entry apart, over {GRAD_REL}"
                      for k, v in g["grads"].items() if v > GRAD_REL]
    for d, g in gaps.get("mesh_refresh", {}).items():
        found += [f"mesh refresh on {d}: {k} {g[k]:.3g} apart, over {GRID_ABS} (faces {g['faces']} | {g['faces_ref']})"
                  for k in ("vertex_gap", "bake_gap") if not g[k] <= GRID_ABS]
    for d, g in gaps.get("instance_mask", {}).items():
        if g["pixels"] > MASK_EDGE_PIXELS or g["off_edge"]:
            found.append(f"instance masks on {d}: {g['pixels']} pixels differ ({g['off_edge']} off a mask's edge), "
                         f"limit {MASK_EDGE_PIXELS} on the edge")
        if g["keypoint_px"] > KEYPOINT_PX:
            found.append(f"keypoints on {d}: {g['keypoint_px']:.3g} px apart, over {KEYPOINT_PX}")
    found += [f"SAM stage on {d}: {g['abs']:.3g} apart, over {SAM_ABS}" for d, g in gaps.get("sam", {}).items()
              if g["abs"] > SAM_ABS]
    return found


def summary(gaps: dict) -> str:
    """One line: the largest gap of each check, by device."""
    parts = []
    for name in ("joint_step", "pose_step", "opt_depth", "joint_step_bf16", "pose_step_bf16", "opt_depth_bf16"):
        if "skipped" in gaps.get(name, {}):
            parts.append(f"{name} skipped: {gaps[name]['skipped']}")
        for d, g in gaps.get(name, {}).items():
            if d in ("loss", "skipped"):
                continue
            parts.append(f"{name} {d}: loss {gaps[name]['loss']}, max term gap {max(g['terms'].values(), default=0):.3g}, "
                         f"max gradient gap {max(g['grads'].values(), default=0):.3g} "
                         f"({max(g['grads'], key=g['grads'].get, default='-')})")
    for d, g in gaps.get("mesh_refresh", {}).items():
        parts.append(f"mesh refresh {d}: {g}")
    for d, g in gaps.get("instance_mask", {}).items():
        parts.append(f"instance masks {d}: {g}")
    for d, g in gaps.get("sam", {}).items():
        parts.append(f"SAM stage {d}: {g}")
    return f"epoch {gaps.get('epoch')}: " + "; ".join(parts)
