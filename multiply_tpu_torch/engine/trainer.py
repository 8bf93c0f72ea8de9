"""Per-scene optimisation: the epoch loop, the per-frame mode, the epoch-end
self-refinement stages, the pose-only depth optimisation and checkpoints.

Counterpart of `multiply_tpu/engine/trainer.py`:
  * per-frame mode: joint, pose-only (in the pose windows, with the mesh
    losses of a `PoseLossBatch`) or delayed-pose (uncertain frames, edge rays);
  * every 20 epochs the canonical meshes are extracted again and the
    per-person SDF grids of the in/off-surface terms re-baked;
  * every `val_every` epochs the instance-mask and SAM stages write the files
    that the data layer reads back, and a validation frame is rendered;
  * opt_depth at the configured epochs: per frame, an inner Adam loop on the
    translations (or the whole pose) against depth-order, interpenetration
    and render losses;
  * checkpoints every `ckpt_every` epochs and at the end, resumable.

Threads. Each epoch's batches are made by a producer thread while the main
thread steps; with `model.stage_overlap` the stages run in a worker thread
while training goes on. The main thread updates the parameters in place, so
another thread never reads them: it works on `_params_snapshot()`, a detached
copy, through `torch.func.functional_call` (see `canonical_sdf_fn`). That
call swaps a module's parameters for the duration of the call, so it never
runs on the renderer that the step uses: SDF queries run on a private copy of
it, one at a time under a lock.
Randomness: host draws use `np.random.default_rng(seed)` in the JAX package's
order; step noise comes from `self.gen`, a `torch.Generator`, through
`TrainStep.draw_noise`.

Several devices (`group`, a `parallel.RayGroup`; counterpart of JAX's
`devices` mesh): rank 0 is the controller. It alone runs the producer thread,
draws each step's noise for the whole batch, runs every epoch-end stage and
writes every file. Each step it sends the whole batch, its pose-loss payload
and its noise to the other ranks, which wait in `follow()`, and every rank
steps on its share of the rays (`parallel.sharded_train_step`). After a stage
that changes what the step reads, rank 0 sends that too: the refreshed grids,
and after opt_depth the parameters and both Adam states. A stage-overlap
harvest is rank 0's decision, reaching the others as a grid message.
"""

from __future__ import annotations

import copy
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from ..body.params import BodyParamTable
from ..body.server import smpl_server_forward
from ..data.dataset import weighted_sampling
from ..models.deformer import SMPLDeformer
from ..models.loss import LossConfig, total_loss
from ..models.renderer import ID_LATENT, IMPLICIT_MODULES, MultiplyRenderer, RenderInputs
from ..native import rasterize_depth
from ..ops.mesh_ops import sdf_grid
from ..utils.cameras import get_camera_params
from ..utils.io import write_png
from ..utils.logging import MetricsLogger
from ..utils.profiling import count, new_id, set_id, span
from .instance_masks import project_depth, run_instance_mask_stage
from .mesh_export import generate_mesh, save_ply
from .optim import AdamState, adam_init, adam_update
from .pose_losses import depth_loss_schedule, interpenetration_loss, sparse_depth_order_loss, sparse_silhouette_loss
from .train import MODE_DELAYED_POSE, MODE_JOINT, MODE_POSE_ONLY, Batch, PoseLossBatch, TrainStep

BODY_FIELDS = ("betas", "global_orient", "transl", "body_pose")


def _jet_rgb() -> np.ndarray:
    """OpenCV's COLORMAP_JET as a (256, 3) uint8 RGB table: slopes of 4 a
    level, clipped to [0, 255]; OpenCV rounds entry 159's blue down to 1."""
    i = np.arange(256)
    r = np.minimum(4 * i - 382, 1148 - 4 * i)
    g = np.minimum(4 * i - 128, 892 - 4 * i)
    b = np.minimum(4 * i + 128, 638 - 4 * i)
    table = np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
    table[159, 2] = 1
    return table


JET_RGB = _jet_rgb()


def depth_colormap(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 RGB: 2.5..5 mapped to JET, near red."""
    d = ((np.clip(depth, 2.5, 5.0) - 2.5) / 2.5 * 255).astype(np.uint8)
    return JET_RGB[255 - d]


def _pad_mesh_to(verts: np.ndarray, faces: np.ndarray, v_to: int, f_to: int):
    """Pad mesh arrays to exact sizes. Padding vertices repeat a real vertex
    (points at the origin would enter the interpenetration samples); padding
    faces are degenerate (0, 0, 0)."""
    verts_p = np.full((v_to, 3), verts[-1] if len(verts) else 0.0, np.float32)
    verts_p[: len(verts)] = verts
    faces_p = np.zeros((f_to, 3), np.int64)
    faces_p[: len(faces)] = faces
    return verts_p, faces_p


def _bucket_size(n: int, base: int) -> int:
    """The least power-of-two multiple of `base` that is >= n: a bounded set of
    padded mesh shapes for at most 2x padding."""
    b = base
    while b < n:
        b *= 2
    return b


def _pad_mesh(verts: np.ndarray, faces: np.ndarray, bucket: int = 8192):
    """Pad a mesh's vertex and face counts to their buckets."""
    return _pad_mesh_to(verts, faces, _bucket_size(len(verts), bucket), _bucket_size(len(faces), bucket))


def draw_pose_pixels(sam_logits: np.ndarray, M: int, rng: np.random.Generator):
    """M pixels where the SAM masks (H, W, P logits) are confident (their
    probabilities sum to 0.7-1.01), drawn with replacement only when there are
    fewer: (uv (M, 2), probabilities there (M, P), n_valid / M), or None."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(sam_logits, np.float32)))
    total = probs.sum(-1)
    vy, vx = np.nonzero((total >= 0.7) & (total <= 1.01))
    if len(vx) == 0:
        return None
    sel = rng.choice(len(vx), M, replace=len(vx) < M)
    return np.stack([vx[sel], vy[sel]], -1).astype(np.float32), probs[vy[sel], vx[sel]], len(vx) / M


def pose_batch_from_meshes(meshes, uv, sam_probs, scale_to_full, bucket: int, device) -> PoseLossBatch:
    """A `PoseLossBatch` on `device`: the persons' [(verts, faces)] padded to
    one shared bucket, and the pixels with their SAM probabilities."""
    v_to = max(_bucket_size(len(v), bucket) for v, _ in meshes)
    f_to = max(_bucket_size(len(f), bucket) for _, f in meshes)
    padded = [_pad_mesh_to(v, f, v_to, f_to) for v, f in meshes]
    return PoseLossBatch(
        verts_c=torch.as_tensor(np.stack([v for v, _ in padded]), device=device),
        faces=torch.as_tensor(np.stack([f for _, f in padded]), device=device),
        uv=torch.as_tensor(np.asarray(uv, np.float32), device=device),
        sam_probs=torch.as_tensor(np.asarray(sam_probs, np.float32), device=device),
        scale_to_full=float(scale_to_full),
    )


class Trainer:
    def __init__(self, conf, seq, servers: list, run_dir: str = ".", segmenter: Callable | None = None,
                 seed: int = 42, device="cuda", group=None):
        self.conf = conf
        self.group = group
        self.seq = seq
        self.run_dir = run_dir
        self.segmenter = segmenter
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(self.device).manual_seed(seed)

        model_conf = conf.model
        self.num_person = seq.num_person
        self.num_frames = len(seq)
        self.renderer = MultiplyRenderer(
            model_conf, num_persons=self.num_person, num_frames=self.num_frames,
            generator=torch.Generator(self.device).manual_seed(seed), device=self.device,
        )
        self.grid_res = int(model_conf.get("cano_grid_res", 64))
        self.mesh_res_up = int(model_conf.get("cano_mesh_res_up", 2))
        # the SMPL-surface term samples no head, hand or foot vertex where the
        # vertex segmentation is available
        surface_logits = None
        seg_path = str(model_conf.get("smpl_vert_segmentation", "outputs/smpl_vert_segmentation.json"))
        if model_conf.loss.get("smpl_surface_weight", 0) > 0 and os.path.exists(seg_path):
            from ..body.segmentation import surface_sample_logits

            surface_logits = [surface_sample_logits(seg_path, s.verts_c.shape[0]) for s in servers]
        # canonical SDF queries swap parameters into this copy, never into the live renderer
        self._sdf_renderer = copy.deepcopy(self.renderer)
        self._sdf_lock = threading.Lock()
        self.servers = servers
        self.person_state = self.renderer.build_person_state(servers, surface_logits=surface_logits,
                                                             grid_res=self.grid_res)

        self.loss_cfg = LossConfig.from_config(model_conf.loss)
        self.interp_samples = int(model_conf.get("interp_samples", 5120))
        self.builder = TrainStep(
            self.renderer, self.person_state, self.loss_cfg, learning_rate=model_conf.learning_rate,
            sched_milestones=tuple(model_conf.sched_milestones), sched_factor=model_conf.sched_factor,
            interp_samples=self.interp_samples,
        )

        # schedules
        self.pose_correction_epoch = model_conf.get("pose_correction_epoch", 500)
        self.depth_end = bool(model_conf.get("depth_end", False))
        self.pose_start_epoch = model_conf.get("pose_start_epoch", 200)
        self.pose_end_epoch = model_conf.get("pose_end_epoch", 1000)
        self.pose_opt_interval = model_conf.get("pose_opt_interval", 10)
        self.pose_opt_epoch = model_conf.get("pose_opt_epoch", 1)
        self.depth_pose = bool(model_conf.get("depth_pose", False))
        self.depth_epoch = list(model_conf.get("depth_epoch", []))
        self.depth_cond_zero = bool(model_conf.get("depth_cond_zero", False))
        self.it_per_loop = model_conf.get("it_per_loop", 100)
        self.depth_pixel_samples = int(model_conf.get("depth_pixel_samples", 4096))
        self.pose_pixel_samples = int(model_conf.get("pose_pixel_samples", 2048))
        self.mesh_pad_bucket = int(model_conf.get("mesh_pad_bucket", 8192))
        self.using_sam = bool(conf.dataset.train.get("using_SAM", True))
        self.depth_order_weight = model_conf.loss.get("depth_order_weight", 0.005)
        self.interpenetration_weight = model_conf.loss.get("interpenetration_loss_weight", 0.0)
        self.silhouette_weight = model_conf.loss.get("silhouette_weight", 0.0)

        tables = [
            BodyParamTable.create(
                self.num_frames, betas=seq.shape[p], global_orient=seq.poses[:, p, :3],
                transl=seq.trans[:, p], body_pose=seq.poses[:, p, 3:], device=self.device,
            )
            for p in range(self.num_person)
        ]
        self.ts = self.builder.init_state(BodyParamTable.stack(tables))
        self.epoch = 0
        if model_conf.get("smpl_init", False) and (group is None or group.rank == 0):
            self._apply_smpl_init(model_conf)
        if group is not None:
            from ..parallel import sharded_train_step

            self._sharded_step = sharded_train_step(self.builder, group)
            self.replicate_state()  # rank 0's weights (its SMPL init) everywhere

    def _apply_smpl_init(self, model_conf) -> None:
        """Start the SDF fields as the canonical body instead of a sphere: one
        pretrained (and cached) network per gender."""
        from ..models.networks import ImplicitNet
        from .smpl_init import get_or_pretrain

        steps = int(model_conf.get("smpl_init_steps", 2000))
        cache_dir = str(model_conf.get("smpl_init_cache_dir", "outputs"))
        genders = getattr(self.seq, "genders", ["neutral"] * self.num_person)
        per_gender: dict = {}
        for p in range(self.num_person):
            g = genders[p]
            if g not in per_gender:
                net = ImplicitNet.from_config(model_conf.implicit_network, device=self.device,
                                              generator=torch.Generator(self.device).manual_seed(0))
                cache = os.path.join(cache_dir, f"smpl_init_{g}.npz")
                per_gender[g] = get_or_pretrain(net, self.servers[p], cache, steps=steps)
            with torch.no_grad():
                for name, param in self.renderer.fg_implicit.named_parameters():
                    param[p].copy_(per_gender[g][name])

    # ------------------------------------------------------------------
    # mode selection per frame
    # ------------------------------------------------------------------

    def _pose_epoch(self) -> bool:
        """Whether the schedule makes this a pose-only epoch: inside the pose
        window, on its interval, and not left to opt_depth (`depth_end`)."""
        ep = self.epoch
        return (
            ep >= self.pose_start_epoch
            and ep % self.pose_opt_interval < self.pose_opt_epoch
            and ep < self.pose_end_epoch
            and not self.depth_end
        )

    def _select_mode(self, is_certain: bool, has_sam: bool) -> int:
        is_pose_depth = has_sam and self._pose_epoch()
        if self.using_sam:
            if is_pose_depth:
                return MODE_POSE_ONLY
            if self.epoch < self.pose_correction_epoch and not is_certain:
                return MODE_DELAYED_POSE
        return MODE_JOINT

    def _pose_window(self) -> bool:
        """Whether this epoch can make pose-only steps: `_select_mode` gives
        MODE_POSE_ONLY for a frame with SAM masks exactly when this holds."""
        return self.using_sam and self._pose_epoch()

    # ------------------------------------------------------------------
    # canonical SDF queries
    # ------------------------------------------------------------------

    def _params_snapshot(self) -> dict:
        """A detached copy of every parameter, by name: what a thread other
        than the main one reads, while the main thread updates the live ones."""
        return {k: p.detach().clone() for k, p in self.ts.params().items()}

    def _live_params(self) -> dict:
        return {k: p.detach() for k, p in self.ts.params().items()}

    def canonical_sdf_fn(self, person_id: int, cond_pose=None, params: dict | None = None):
        """Host callable (N, 3) -> (N,) of one person's canonical SDF, with the
        offset head, beta encoder or tri-plane where configured. `params` is a
        `_params_snapshot()` (default: the live parameters, main thread only)."""
        params = self._live_params() if params is None else params
        r = self.renderer
        if cond_pose is None:
            cond = torch.zeros(69 + ID_LATENT if r.use_person_encoder else 69, device=self.device)
        else:
            cond = torch.as_tensor(np.asarray(cond_pose, np.float32), device=self.device)
            if r.use_person_encoder:
                cond = torch.cat([cond, params["net.person_latent"][person_id]])
        bundle = {}
        for name in IMPLICIT_MODULES:
            if getattr(r, name) is None:
                continue
            prefix = f"net.{name}."
            shared = name == "fg_implicit" and r.use_person_encoder
            bundle[name] = {
                k[len(prefix):]: v if shared else v[person_id : person_id + 1]
                for k, v in params.items() if k.startswith(prefix)
            }
        betas = params["body.betas"][person_id, 0][None]
        cond = cond[None]

        def sdf(pts: np.ndarray) -> np.ndarray:
            with span("mesh.sdf"):
                count("mesh.sdf_points", len(pts))
                x = torch.as_tensor(np.asarray(pts, np.float32), device=self.device)[None]
                with self._sdf_lock, torch.no_grad():
                    out = self._sdf_renderer._implicit(x, cond, betas, bundle=bundle)
                return out[0, :, 0].cpu().numpy()

        return sdf

    def _canonical_mesh(self, p: int, cond_pose=None, params=None, res_up: int | None = None):
        with span("mesh.extract"):
            return generate_mesh(
                self.canonical_sdf_fn(p, cond_pose, params=params), self.servers[p].verts_c.cpu().numpy(),
                res_up=self.mesh_res_up if res_up is None else res_up,
            )

    def extract_canonical_meshes(self, res_up: int | None = None, cond_pose_per_person=None, params=None):
        return [
            self._canonical_mesh(p, None if cond_pose_per_person is None else cond_pose_per_person[p],
                                 params=params, res_up=res_up)
            for p in range(self.num_person)
        ]

    def _compute_canonical_grids(self, params=None) -> dict:
        """Bake each person's in/off-surface SDF grid from its learned canonical
        mesh; a person whose mesh fails keeps its grid. Pure compute: a worker
        thread may run it on a snapshot; `_apply_canonical_grids` applies it."""
        grids = []
        for p in range(self.num_person):
            try:
                verts, faces = self._canonical_mesh(p, params=params)
                if len(verts) < 16 or len(faces) < 16:
                    raise ValueError("degenerate mesh")
                grids.append(sdf_grid(torch.as_tensor(verts, device=self.device),
                                      torch.as_tensor(faces, device=self.device), res=self.grid_res))
            except Exception as e:  # keep the previous grid, as the reference does
                print(f"canonical mesh refresh failed for person {p}: {e}")
                grids.append({k: v[p] for k, v in self.person_state.cano_grid.items()})
        return {k: torch.stack([g[k] for g in grids]) for k in grids[0]}

    def _apply_canonical_grids(self, stacked: dict) -> None:
        """Swap in new grids. The step reads `builder.state`, so it is replaced
        too: the next step's kernel reads the new grid (on every rank)."""
        if self.group is not None:
            stacked = self._command("grids", stacked)
        self.person_state = self.person_state._replace(cano_grid=stacked)
        self.builder.state = self.person_state

    def refresh_canonical_state(self, params=None) -> None:
        self._apply_canonical_grids(self._compute_canonical_grids(params))

    # ------------------------------------------------------------------
    # posed and deformed meshes
    # ------------------------------------------------------------------

    def _smpl_out(self, params: dict, p: int, frame_idx: int) -> dict:
        """Person p's SMPL forward at a frame, in the scene's scale."""
        thetas = torch.cat([params["body.global_orient"][p, frame_idx], params["body.body_pose"][p, frame_idx]])
        return smpl_server_forward(
            self.servers[p], torch.tensor(float(self.seq.scale), device=self.device),
            params["body.transl"][p, frame_idx], thetas, params["body.betas"][p, 0],
        )

    def _person_deformer(self, p: int) -> SMPLDeformer:
        return SMPLDeformer(*(x[p] for x in self.person_state.deformer))

    def deformed_meshes_for_frame(self, frame_idx: int, res_up: int | None = None, unscale: bool = True,
                                  params=None):
        """Canonical meshes with the frame's pose conditioning, warped to the
        frame's pose: ([(verts, faces)], [joints]), unscaled (1 / scale)."""
        params = self._live_params() if params is None else params
        scale = float(self.seq.scale)
        meshes, joints = [], []
        for p in range(self.num_person):
            cond = params["body.body_pose"][p, frame_idx].cpu().numpy() / np.pi
            verts_c, faces = self._canonical_mesh(p, cond, params=params, res_up=res_up)
            with torch.no_grad():
                out = self._smpl_out(params, p, frame_idx)
                verts_d = self._person_deformer(p).forward(
                    torch.as_tensor(verts_c, device=self.device), out["smpl_tfs"]).cpu().numpy()
            j = out["smpl_all_jnts"].detach().cpu().numpy()
            meshes.append((verts_d / scale if unscale else verts_d, faces))
            joints.append(j / scale if unscale else j)
        return meshes, joints

    # ------------------------------------------------------------------
    # epoch-end stages
    # ------------------------------------------------------------------

    def instance_mask_stage(self, max_workers: int = 4, params=None, epoch: int | None = None) -> None:
        """Frames are independent: a thread pool runs them (the C++ octree and
        rasterizer release the interpreter lock; SDF evaluations queue on the card)."""
        epoch = self.epoch if epoch is None else epoch
        stage_params = self._live_params() if params is None else params
        scale = float(self.seq.scale)

        def frame_payload(i: int) -> dict:
            item = self.seq.get_eval_item(i)
            if epoch <= 190:  # SMPL meshes as the prompts early on
                meshes, joints = [], []
                with torch.no_grad():
                    for p in range(self.num_person):
                        out = self._smpl_out(stage_params, p, i)
                        meshes.append((out["smpl_verts"].cpu().numpy() / scale,
                                       self.servers[p].model.faces.cpu().numpy()))
                        joints.append(out["smpl_all_jnts"].cpu().numpy() / scale)
            else:
                meshes, joints = self.deformed_meshes_for_frame(i, params=stage_params)
            return {"P": item["P"] @ np.diag([scale] * 3 + [1.0]), "img_size": item["img_size"],
                    "meshes": meshes, "joints": joints}

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            frames = list(pool.map(frame_payload, range(self.num_frames)))
        run_instance_mask_stage(epoch, frames, out_dir=self.run_dir)

    def sam_stage(self, epoch: int | None = None) -> None:
        if self.segmenter is not None:
            self.segmenter(self.epoch if epoch is None else epoch, run_dir=self.run_dir)

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------

    def pose_loss_batch(self, frame_idx: int, rng: np.random.Generator, params=None) -> PoseLossBatch | None:
        """Mesh payload of a pose-only step: each person's canonical mesh with
        the frame's pose conditioning, padded to a shared bucket, and a draw of
        SAM-confident pixels. None until full-image SAM masks exist.
        `params`: a snapshot, for the producer thread."""
        sam = getattr(self.seq, "_sam_masks", None)
        drawn = None if sam is None else draw_pose_pixels(sam[frame_idx], self.pose_pixel_samples, rng)
        if drawn is None:
            return None
        params = self._live_params() if params is None else params
        meshes = []
        for p in range(self.num_person):
            cond = params["body.body_pose"][p, frame_idx].cpu().numpy() / np.pi
            try:
                verts_c, faces = self._canonical_mesh(p, cond, params=params)
                if len(verts_c) < 16 or len(faces) < 16:
                    raise ValueError("degenerate mesh")
            except Exception as e:  # the SMPL body instead, early in training
                print(f"pose-loss mesh extraction failed for person {p}: {e}")
                verts_c = self.servers[p].verts_c.cpu().numpy()
                faces = self.servers[p].model.faces.cpu().numpy()
            meshes.append((verts_c, faces))
        return pose_batch_from_meshes(meshes, *drawn, self.mesh_pad_bucket, self.device)

    def make_batch(self, item: dict, mode: int) -> Batch:
        edge = mode == MODE_DELAYED_POSE

        def pick(key):
            return item[f"edge_{key}"] if edge and f"edge_{key}" in item else item.get(key)

        sam = pick("sam_mask")
        if sam is None:
            sam = np.zeros((len(item["uv"]), self.num_person), np.float32)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        return Batch(uv=t(pick("uv")), rgb=t(pick("rgb")), pose=t(item["pose"]), intrinsics=t(item["intrinsics"]),
                     frame_idx=int(item["idx"]), smpl_scale=t(item["smpl_scale"]), sam_mask=t(sam), mode=mode)

    # ------------------------------------------------------------------
    # several devices
    # ------------------------------------------------------------------

    def replicate_state(self) -> None:
        """Rank 0's parameters, both Adam states and per-person state (the
        canonical grids among it) on every rank: each rank calls this at the
        same point."""
        from ..parallel import replicate

        replicate([self.ts.params(), self.ts.opt_joint, self.ts.opt_pose, self.person_state], self.group)

    def _command(self, kind: str, payload=None):
        """Rank 0: send the other ranks what to do next (`follow` runs it) with
        its tensors; every rank returns the payload on its own device."""
        from ..parallel.sharding import broadcast_tree

        msg = broadcast_tree({"kind": kind, "epoch": self.epoch, "payload": payload}, self.group)
        return msg["payload"]

    def follow(self) -> None:
        """The loop of a rank other than 0: step on its share of the rays and
        take the state rank 0 sends, until rank 0 says stop."""
        from ..parallel.sharding import broadcast_tree

        while True:
            msg = broadcast_tree(None, self.group)
            self.epoch = self.ts.epoch = msg["epoch"]
            kind, payload = msg["kind"], msg["payload"]
            if kind == "step":
                batch, pose_batch, noise = payload
                self.ts, _ = self._sharded_step(self.ts, batch, noise=noise, pose_batch=pose_batch)
            elif kind == "grids":
                self.person_state = self.person_state._replace(cano_grid=payload)
                self.builder.state = self.person_state
            elif kind == "state":
                self.replicate_state()
            elif kind == "stop":
                return
            else:
                raise ValueError(f"unknown message {kind!r} from rank 0")

    def release_followers(self) -> None:
        """Rank 0: end the other ranks' `follow` loops."""
        self._command("stop")

    def train_step(self, batch: Batch, pose_batch: PoseLossBatch | None = None):
        """One optimisation step on the whole batch; returns (ts, logs). Over
        a ray group, rank 0 draws the whole batch's noise, sends the step to
        the other ranks, and each rank steps on its share of the rays."""
        with span("step"):
            if self.group is None:
                return self.builder.step(self.ts, batch, generator=self.gen, pose_batch=pose_batch)
            noise = self.builder.draw_noise(batch, pose_batch, self.gen)
            batch, pose_batch, noise = self._command("step", (batch, pose_batch, noise))
            return self._sharded_step(self.ts, batch, noise=noise, pose_batch=pose_batch)

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def train_epoch(self, max_steps: int | None = None) -> dict:
        """One pass over the shuffled frames (the first `max_steps` of them,
        if given). A producer thread makes the next step's whole batch (item
        draw, pose-loss meshes, host-to-card copies) while the main thread
        steps. Each batch gets a number of its own (`utils/profiling.new_id`),
        the id of its spans and counters in the producer and the main thread."""
        order = self.rng.permutation(self.num_frames)
        # separate generators, so that a mode flip does not shift the item draws
        item_rng = np.random.default_rng(self.rng.integers(0, 2**31))
        pose_rng = np.random.default_rng(self.rng.integers(0, 2**31))
        q: queue.Queue = queue.Queue(maxsize=2)
        # pose-only epochs: the producer meshes an epoch-start copy of the params
        snap = self._params_snapshot() if self._pose_window() else None

        def producer():
            try:
                for i in order[:max_steps]:
                    batch_id = new_id()
                    set_id(batch_id)
                    with span("producer.item"):
                        item = self.seq.get_train_item(int(i), item_rng)
                    mode = self._select_mode(item.get("is_certain", True), "sam_mask" in item)
                    pose_batch = None
                    if mode == MODE_POSE_ONLY:
                        with span("producer.pose_batch"):
                            pose_batch = self.pose_loss_batch(int(i), pose_rng, params=snap)
                    with span("producer.h2d"):
                        batch = self.make_batch(item, mode)
                    with span("producer.put_wait"):
                        q.put((batch_id, mode, batch, pose_batch))
                q.put(None)
            except BaseException as e:  # raised again in the main thread
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        logs = None
        mode_counts = {MODE_JOINT: 0, MODE_POSE_ONLY: 0, MODE_DELAYED_POSE: 0}
        self.ts.epoch = self.epoch
        try:
            with span("epoch"):
                while True:
                    with span("loop.queue_get"):
                        empty = q.empty()
                        got = q.get()
                        set_id(got[0] if isinstance(got, tuple) else None)
                    if got is None:
                        break
                    if isinstance(got, BaseException):
                        raise got
                    if empty:
                        count("loop.queue_empty")
                    _, mode, batch, pose_batch = got
                    mode_counts[mode] += 1
                    self.ts, logs = self.train_step(batch, pose_batch)
        finally:
            set_id(None)
            while t.is_alive():  # let a blocked producer finish before leaving
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        out = {k: float(v) for k, v in (logs or {}).items()}
        out["n_joint"] = float(mode_counts[MODE_JOINT])
        out["n_pose_only"] = float(mode_counts[MODE_POSE_ONLY])
        out["n_delayed_pose"] = float(mode_counts[MODE_DELAYED_POSE])
        return out

    def fit(self, max_epochs: int, log_every: int = 10, ckpt_every: int = 100, val_every: int = 50,
            ckpt_dir: str | None = None, render_val: bool = True) -> None:
        """The epoch loop with its epoch-end stages. Each synchronous stage's
        seconds go to the metrics file as `<stage>_seconds`.

        With `model.stage_overlap` the /20 mesh refresh and the instance-mask +
        SAM stages run in a worker thread on a params snapshot while the next
        epoch trains: their outputs are read on the next pass anyway, so one
        epoch of staleness changes nothing the loop relies on."""
        overlap = bool(self.conf.model.get("stage_overlap", False))
        stage_pool = ThreadPoolExecutor(max_workers=1) if overlap else None
        mesh_fut = None  # -> stacked grids, applied on the main thread
        mask_fut = None  # -> None (publishes files the data layer polls)
        metrics = MetricsLogger(self.run_dir)

        def harvest(wait_mesh: bool, wait_mask: bool) -> None:
            nonlocal mesh_fut, mask_fut
            if mesh_fut is not None and (wait_mesh or mesh_fut.done()):
                try:
                    self._apply_canonical_grids(mesh_fut.result())
                except Exception as e:  # a stage failure never ends training
                    print(f"overlapped mesh refresh failed: {e}")
                mesh_fut = None
            if mask_fut is not None and (wait_mask or mask_fut.done()):
                try:
                    mask_fut.result()
                except Exception as e:
                    print(f"overlapped mask/SAM stage failed: {e}")
                mask_fut = None

        def timed(name: str, fn, *args):
            t0 = time.time()
            result = fn(*args)
            metrics.log({f"{name}_seconds": time.time() - t0}, epoch=self.epoch)
            return result

        try:
            for _ in range(max_epochs - self.epoch):
                t0 = time.time()
                logs = self.train_epoch()
                logs["epoch_seconds"] = time.time() - t0
                metrics.log(logs, epoch=self.epoch)
                if self.epoch % log_every == 0:
                    msg = " ".join(f"{k}={v:.4f}" for k, v in logs.items() if k != "lr")
                    print(f"epoch {self.epoch} ({logs['epoch_seconds']:.1f}s) {msg}")
                if overlap:
                    harvest(wait_mesh=False, wait_mask=False)

                if self.epoch != 0 and self.epoch % 20 == 0:
                    if overlap:
                        harvest(wait_mesh=True, wait_mask=False)
                        mesh_fut = stage_pool.submit(self._compute_canonical_grids, self._params_snapshot())
                    else:
                        timed("mesh_refresh", self.refresh_canonical_state)
                if self.epoch % val_every == 0 and self.using_sam:
                    if overlap:
                        harvest(wait_mesh=False, wait_mask=True)
                        snap, ep = self._params_snapshot(), self.epoch

                        def mask_job(snap=snap, ep=ep):
                            self.instance_mask_stage(params=snap, epoch=ep)
                            self.sam_stage(epoch=ep)

                        mask_fut = stage_pool.submit(mask_job)
                    else:
                        timed("instance_mask", self.instance_mask_stage)
                        timed("sam", self.sam_stage)
                if self.epoch % val_every == 0 and render_val:
                    try:
                        psnr = timed("validation", self.validate)
                        metrics.log({"val_psnr": psnr}, epoch=self.epoch)
                    except Exception as e:  # validation never ends training
                        print(f"validation render failed: {e}")
                if self.epoch in self.depth_epoch and self.depth_end:
                    if overlap:  # opt_depth rewrites body params: settle the stages first
                        harvest(wait_mesh=True, wait_mask=True)
                    timed("opt_depth", self.opt_depth)
                if ckpt_dir and self.epoch % ckpt_every == 0:
                    self.save_checkpoint(ckpt_dir)
                self.epoch += 1
            if overlap:
                harvest(wait_mesh=True, wait_mask=True)
            if ckpt_dir:
                self.save_checkpoint(ckpt_dir, tag="last")
        finally:
            if stage_pool is not None:
                stage_pool.shutdown(wait=True)
            metrics.close()

    def validate(self, frame_idx: int | None = None) -> float:
        """Render one frame beside its ground truth into `val/`, export each
        person's canonical mesh there, and return the PSNR."""
        from .evaluator import Evaluator

        if frame_idx is None:
            frame_idx = int(self.rng.integers(0, self.num_frames))
        if not hasattr(self, "_evaluator"):
            self._evaluator = Evaluator(
                self.renderer, self.person_state, self.servers,
                pixel_per_batch=int(self.conf.dataset.get("valid", {}).get("pixel_per_batch", 512)),
            )
        item = self.seq.get_eval_item(frame_idx)
        merged = self._evaluator.render_image(self.ts.body, item, epoch=self.epoch, person_state=self.person_state)
        H, W = item["img_size"]
        gt = np.asarray(item["rgb"], np.float32).reshape(H, W, 3)
        side = np.concatenate([gt, merged["rgb_image"]], axis=1)
        out_dir = os.path.join(self.run_dir, "val")
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, f"epoch_{self.epoch:05d}.png"), (np.clip(side, 0, 1) * 255).astype(np.uint8))
        try:
            for p, (verts, faces) in enumerate(self.extract_canonical_meshes()):
                save_ply(os.path.join(out_dir, f"epoch_{self.epoch:05d}_person_{p}.ply"), verts, faces)
        except Exception as e:
            print(f"validation mesh export failed: {e}")
        psnr = merged.get("psnr", 0.0)
        print(f"validation epoch {self.epoch}: PSNR {psnr:.2f} dB")
        return psnr

    # ------------------------------------------------------------------
    # opt_depth: per-frame translation refinement
    # ------------------------------------------------------------------

    def opt_depth(self) -> None:
        print(f"opt_depth at epoch {self.epoch}")
        if self.seq._sam_masks is None:
            print("no SAM masks yet; skipping opt_depth")
            return
        for frame_idx in range(self.num_frames):
            self._opt_depth_frame(frame_idx)
        if self.group is not None:  # the other ranks' steps read the new body parameters
            self._command("state")
            self.replicate_state()

    def _opt_depth_frame(self, frame_idx: int) -> None:
        item = self.seq.get_eval_item(frame_idx)
        H, W = item["img_size"]
        frame = self.seq.load_frame(frame_idx)  # full-image arrays for the anchor rays
        sam = self.seq._sam_masks[frame_idx]  # (H, W, P) logits
        sam_probs_full = 1.0 / (1.0 + np.exp(-sam))

        # canonical meshes, once per frame
        params = self._live_params()
        meshes = []
        for p in range(self.num_person):
            cond = (np.zeros(69, np.float32) if self.depth_cond_zero
                    else params["body.body_pose"][p, frame_idx].cpu().numpy() / np.pi)
            meshes.append(self._canonical_mesh(p, cond))

        # the SAM-confident pixels, drawn once
        sam_sum = sam_probs_full.sum(-1)
        vy, vx = np.nonzero((sam_sum >= 0.7) & (sam_sum <= 1.01))
        n_valid = len(vx)
        if n_valid == 0:
            return
        M = min(self.depth_pixel_samples, n_valid)
        sel = self.rng.choice(n_valid, M, replace=False)
        uv = np.stack([vx[sel], vy[sel]], -1).astype(np.float32)
        pose_batch = pose_batch_from_meshes(meshes, uv, sam_probs_full[vy[sel], vx[sel]], n_valid / M,
                                            self.mesh_pad_bucket, self.device)
        padded = [(v.cpu().numpy(), f.cpu().numpy()) for v, f in zip(pose_batch.verts_c, pose_batch.faces)]
        d_sched = depth_loss_schedule(1.0, self.epoch)

        # the anchor's rays: fresh weighted samples each iteration
        n_rays = int(self.conf.model.get("depth_render_rays", 512))
        ray_data = {"rgb": frame["img"], "uv": frame["uv"], "object_mask": frame["mask_union"], "sam_mask": sam}
        body = BodyParamTable(*(getattr(self.ts.body, f).detach().clone() for f in BODY_FIELDS))
        body_params = dict(body.named_parameters())
        opt_state = adam_init(body_params)
        active = {k: self.depth_pose or k == "transl" for k in body_params}
        step_fn = self._depth_grad_fn()
        lr = float(self.conf.model.learning_rate)
        skipped = 0
        for it in range(self.it_per_loop):
            samples, _ = weighted_sampling(ray_data, (H, W), n_rays, self.rng)
            batch = self.make_batch(
                {"uv": samples["uv"], "rgb": samples["rgb"], "sam_mask": samples["sam_mask"],
                 "pose": item["pose"], "intrinsics": item["intrinsics"], "idx": frame_idx,
                 "smpl_scale": np.full(self.num_person, self.seq.scale, np.float32)},
                MODE_JOINT,
            )
            noise = self.builder.draw_noise(batch, pose_batch, self.gen)
            opt_state, val, parts, finite = step_fn(body, opt_state, lr, active, batch, pose_batch, noise, d_sched)
            skipped += int(not finite)
            if it == 0 or it == self.it_per_loop - 1:
                print(f"  opt_depth frame {frame_idx} it {it}: total={float(val):.4f} "
                      f"depth={float(parts['depth_order']):.4f} interp={float(parts['interpenetration']):.4f} "
                      f"render={float(parts['render']):.4f}")
                self._dump_depth_maps(frame_idx, it, item, body, padded, sam_probs_full)
        if skipped:
            print(f"  opt_depth frame {frame_idx}: skipped {skipped}/{self.it_per_loop} "
                  "non-finite iterations (NaN guard)")
        with torch.no_grad():
            for f in BODY_FIELDS:
                getattr(self.ts.body, f).copy_(getattr(body, f))

    def _depth_loss(self, body: BodyParamTable, batch: Batch, pose_batch: PoseLossBatch, noise: dict,
                    d_sched: float):
        """opt_depth's objective on one frame: the mesh depth-order and
        interpenetration terms (and silhouette, when weighted) plus the full
        render loss on the anchor rays, added unweighted. The render anchor
        keeps the translations from drifting in the image plane."""
        idx, scale = batch.frame_idx, batch.smpl_scale
        out = smpl_server_forward(self.person_state.server, scale, body.transl[:, idx], body.thetas(idx),
                                  body.betas[:, 0])
        verts_d = self.person_state.deformer.forward(pose_batch.verts_c, out["smpl_tfs"]) / scale[:, None, None]
        verts_list, faces_list = list(verts_d.unbind(0)), list(pose_batch.faces.unbind(0))
        # the meshes are in unscaled (1 / scale) space: scale the rays alike
        ray_d, cam_loc = get_camera_params(pose_batch.uv, batch.pose, batch.intrinsics)
        ray_o = cam_loc.expand_as(ray_d) / scale[0]
        d_loss, _ = sparse_depth_order_loss(ray_o, ray_d, verts_list, faces_list, pose_batch.sam_probs,
                                            scale_to_full=pose_batch.scale_to_full)
        i_loss = interpenetration_loss(verts_list, faces_list, sample_idx=noise["interp_idx"])
        d_w = self.depth_order_weight * d_sched * d_loss
        i_w = self.interpenetration_weight * d_sched * i_loss
        total = d_w + i_w
        if self.silhouette_weight > 0:
            s_loss = sparse_silhouette_loss(ray_o, ray_d, verts_list, faces_list, pose_batch.sam_probs)
            total = total + self.silhouette_weight * d_sched * s_loss

        # render anchor: the full forward and loss on the sampled rays, temporal term off
        inputs = RenderInputs(
            uv=batch.uv, pose=batch.pose, intrinsics=batch.intrinsics, scale=scale, transl=body.transl[:, idx],
            thetas=body.thetas(idx), betas=body.betas[:, 0], frame_idx=idx, epoch=self.epoch,
        )
        rout = self.renderer.render(self.person_state, inputs, train=True, noise=noise, cond_zero=self.depth_cond_zero)
        rout["temporal_loss"] = torch.zeros((), device=self.device)
        render_loss, _ = total_loss(self.loss_cfg, rout, batch.rgb, self.epoch, sam_mask_logits=batch.sam_mask)
        return total + render_loss, {"depth_order": d_w, "interpenetration": i_w, "render": render_loss}

    def _depth_grad_fn(self):
        """One opt_depth iteration on `body` (a `BodyParamTable`, updated in
        place): the loss, its gradients to the body parameters only, and the
        masked Adam update behind the same non-finite skip as the training
        step. A non-finite loss or gradient leaves the parameters and the Adam
        state (moments and counts) as they were. Returns
        (Adam state, loss, parts, finite)."""

        def step_fn(body, opt_state: AdamState, lr, active, batch, pose_batch, noise, d_sched):
            params = dict(body.named_parameters())
            val, parts = self._depth_loss(body, batch, pose_batch, noise, d_sched)
            grads = dict(zip(params, torch.autograd.grad(val, list(params.values()))))
            finite = bool(torch.isfinite(val) & torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
            if finite:
                opt_state = adam_update(grads, opt_state, params, lr, {k: 1.0 for k in params}, active)
            return opt_state, val.detach(), {k: v.detach() for k, v in parts.items()}, finite

        return step_fn

    def _dump_depth_maps(self, frame_idx, it, item, body: BodyParamTable, meshes, sam_probs_full) -> None:
        """stage_depth_map/<epoch>/<it>/{front,gt}: the deformed meshes' depth
        with the current translations, in front and of the SAM-argmax person,
        in OpenCV's JET colours (near is red)."""
        try:
            H, W = item["img_size"]
            scale = float(self.seq.scale)
            P_mat = item["P"] @ np.diag([scale] * 3 + [1.0])
            params = {f"body.{f}": getattr(body, f).detach() for f in BODY_FIELDS}
            depths = []
            with torch.no_grad():
                for p in range(self.num_person):
                    out = self._smpl_out(params, p, frame_idx)
                    vd = self._person_deformer(p).forward(
                        torch.as_tensor(meshes[p][0], device=self.device), out["smpl_tfs"]).cpu().numpy() / scale
                    depths.append(rasterize_depth(project_depth(P_mat, vd).astype(np.float32), meshes[p][1], W, H))
            depth = np.stack(depths, 0)  # (P, H, W), inf = miss
            depth_f = np.where(np.isfinite(depth), depth, 999.0)
            front = depth_f.min(0)
            gt = np.take_along_axis(depth_f, np.argmax(sam_probs_full, axis=-1)[None], axis=0)[0]

            out_dir = os.path.join(self.run_dir, "stage_depth_map", f"{self.epoch:05d}", f"{it:05d}")
            for kind, d in (("front", front), ("gt", gt)):
                os.makedirs(os.path.join(out_dir, kind), exist_ok=True)
                write_png(os.path.join(out_dir, kind, f"{kind}_{frame_idx:04d}.png"), depth_colormap(d))
        except Exception as e:  # debug dumps never end the pass
            print(f"stage_depth_map dump failed: {e}")

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, ckpt_dir: str, tag: str | None = None) -> None:
        """`<ckpt_dir>/epoch_%05d` (or `<tag>`): the net and body parameters,
        both Adam states and the epoch, written whole or not at all."""
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, tag or f"epoch_{self.epoch:05d}")

        def adam(s: AdamState) -> dict:
            return {"mu": s.mu, "nu": s.nu, "count": s.count}

        state = {"params": self._live_params(), "opt_joint": adam(self.ts.opt_joint),
                 "opt_pose": adam(self.ts.opt_pose), "epoch": self.epoch}
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        state = torch.load(path, map_location=self.device, weights_only=True)
        params = self.ts.params()
        if set(state["params"]) != set(params):
            raise ValueError(f"checkpoint {path}: parameters {sorted(set(state['params']) ^ set(params))} differ")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(state["params"][k])
        self.ts.opt_joint = AdamState(**state["opt_joint"])
        self.ts.opt_pose = AdamState(**state["opt_pose"])
        self.epoch = int(state["epoch"])
        self.ts.epoch = self.epoch
        if self.group is not None:  # every rank read the same file; rank 0's copy wins
            self.replicate_state()
