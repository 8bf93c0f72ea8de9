"""The training step with the reference's optimizer-switching schedule.

Counterpart of `multiply_tpu/engine/train.py`:
  * per-frame mode: joint (shape + pose), pose-only, delayed-pose (body,
    frame latents and density beta only);
  * frame-indexed SMPL params read from the optimizable tables;
  * temporal pose smoothness vs the previous frame (epoch > 250);
  * on pose-only frames, with a `PoseLossBatch`, the mesh-based depth-order,
    silhouette and interpenetration losses, weighted and decayed over
    `depth_loss_milestone`;
  * a non-finite loss or gradient drops the whole update: params, moments
    and step counts stay as they were;
  * MultiStepLR per epoch, Adam eps 1e-8, body params at 0.1x lr.

Parameters are named "net.<renderer param>" and "body.<table field>".
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..body.params import BodyParamTable
from ..body.server import smpl_server_forward
from ..models.loss import LossConfig, total_loss
from ..models.renderer import MultiplyRenderer, PersonState, RenderInputs
from ..utils.cameras import get_camera_params
from ..utils.profiling import count, span
from .optim import AdamState, adam_init, adam_update, multistep_lr
from .pose_losses import (
    draw_interpenetration_samples,
    interpenetration_loss,
    sparse_depth_order_loss,
    sparse_silhouette_loss,
)

MODE_JOINT = 0
MODE_POSE_ONLY = 1
MODE_DELAYED_POSE = 2  # uncertain frame: body + latents only, shape frozen

SHAPE_NET_KEYS = ("fg_implicit", "fg_render", "bg_implicit", "bg_render")


@dataclass
class TrainState:
    model: MultiplyRenderer  # the "net" parameters
    body: BodyParamTable  # stacked over persons
    opt_joint: AdamState
    opt_pose: AdamState
    epoch: int = 0

    def params(self) -> dict:
        out = {f"net.{k}": p for k, p in self.model.named_parameters()}
        out.update({f"body.{k}": p for k, p in self.body.named_parameters()})
        return out


@dataclass
class Batch:
    """One frame's ray batch."""

    uv: torch.Tensor  # (R, 2)
    rgb: torch.Tensor  # (R, 3)
    pose: torch.Tensor  # (4, 4)
    intrinsics: torch.Tensor  # (3, 3)
    frame_idx: int
    smpl_scale: torch.Tensor  # (P,)
    sam_mask: torch.Tensor | None = None  # (R, P) logits
    mode: int = MODE_JOINT


@dataclass
class PoseLossBatch:
    """Mesh payload of the pose-opt step losses: each person's canonical mesh,
    padded to a common size so shapes stay fixed across frames, plus a sample
    of pixels where SAM is confident. The meshes are constants inside the step:
    gradients flow through the deformer and the SMPL forward into the
    per-frame SMPL parameters only."""

    verts_c: torch.Tensor  # (P, V, 3) padded canonical verts
    faces: torch.Tensor  # (P, F, 3) int64, padded with degenerate 0,0,0 faces
    uv: torch.Tensor  # (M, 2) sampled pixels
    sam_probs: torch.Tensor  # (M, P) sigmoid SAM probabilities at those pixels
    scale_to_full: torch.Tensor | float  # n_valid_pixels / M (rescales the summed loss)


def _host_wait(flag: torch.Tensor) -> bool:
    """`bool(flag)`: the host waits here for the card to reach it."""
    with span("step.sync"):
        count("step.host_waits")
        return bool(flag)


def make_lr_factors(params: dict, body_factor: float = 0.1) -> dict:
    return {k: body_factor if k.startswith("body.") else 1.0 for k in params}


def _active_masks(params: dict, mode: int) -> dict:
    """joint: everything. pose-only: body only. delayed: body + frame latents + beta."""

    def active(name: str) -> bool:
        if name.startswith("body."):
            return mode in (MODE_JOINT, MODE_POSE_ONLY, MODE_DELAYED_POSE)
        if mode == MODE_JOINT:
            return True
        return mode == MODE_DELAYED_POSE and name.split(".")[1] not in SHAPE_NET_KEYS

    return {k: active(k) for k in params}


class TrainStep:
    def __init__(
        self,
        renderer: MultiplyRenderer,
        person_state: PersonState,
        loss_cfg: LossConfig,
        learning_rate: float = 5e-4,
        sched_milestones: tuple[int, ...] = (200, 500),
        sched_factor: float = 0.5,
        interp_samples: int = 5120,
    ):
        self.renderer = renderer
        self.state = person_state
        self.loss_cfg = loss_cfg
        self.lr = learning_rate
        self.milestones = tuple(sched_milestones)
        self.gamma = sched_factor
        self.interp_samples = interp_samples

    def init_state(self, body_tables: BodyParamTable) -> TrainState:
        """`body_tables`: the stacked-over-persons table; the renderer's own
        parameters are the "net" parameters."""
        ts = TrainState(self.renderer, body_tables, None, None, 0)
        params = ts.params()
        ts.opt_joint = adam_init(params)
        ts.opt_pose = adam_init({k: p for k, p in params.items() if k.startswith("body.")})
        return ts

    def draw_noise(self, batch: Batch, pose_batch: PoseLossBatch | None = None, generator=None) -> dict:
        """All random numbers of one step: the renderer's, plus the
        interpenetration samples ("interp_idx", one index tensor a person) when
        there is a `pose_batch`."""
        noise = self.renderer.draw_noise(
            batch.uv.shape[0], self.state.server.verts_c.shape[-2], generator, self.state.surface_sample_logits
        )
        if pose_batch is not None:
            P, V = pose_batch.verts_c.shape[:2]
            noise["interp_idx"] = draw_interpenetration_samples(
                [V] * P, self.interp_samples, generator, pose_batch.verts_c.device
            )
        return noise

    def _pose_step_losses(self, ts: TrainState, batch: Batch, pose_batch: PoseLossBatch, interp_idx):
        """Raw depth-order, silhouette and interpenetration losses on the
        deformed meshes, differentiable to the per-frame SMPL parameters."""
        body, idx = ts.body, batch.frame_idx
        ray_d, cam_loc = get_camera_params(pose_batch.uv, batch.pose, batch.intrinsics)
        ray_o = cam_loc.expand_as(ray_d)
        smpl_out = smpl_server_forward(
            self.state.server, batch.smpl_scale, body.transl[:, idx], body.thetas(idx), body.betas[:, 0]
        )
        # all persons' meshes in one warp; they live in un-normalised (1 / scale) space
        verts_d = self.state.deformer.forward(pose_batch.verts_c, smpl_out["smpl_tfs"])
        verts_d = verts_d / batch.smpl_scale[:, None, None]
        verts_list, faces_list = list(verts_d.unbind(0)), list(pose_batch.faces.unbind(0))

        ray_o = ray_o / batch.smpl_scale[0]
        d_loss, _ = sparse_depth_order_loss(
            ray_o, ray_d, verts_list, faces_list, pose_batch.sam_probs,
            scale_to_full=pose_batch.scale_to_full,
        )
        i_loss = interpenetration_loss(verts_list, faces_list, sample_idx=interp_idx)
        s_loss = sparse_silhouette_loss(ray_o, ray_d, verts_list, faces_list, pose_batch.sam_probs)
        return d_loss, s_loss, i_loss

    def forward_loss(self, ts: TrainState, batch: Batch, noise=None, generator=None, pose_batch=None,
                     share=None):
        """(loss, logs) of one batch, differentiable w.r.t. `ts.params()`.
        With `share` (a `RayShare`), `batch` and `noise` are this rank's share
        of the rays and the loss and logs are this rank's share of the whole
        batch's; the pose-only terms, computed whole on every rank from the
        replicated `pose_batch`, are weighted 1/W."""
        with span("step.forward"):
            if noise is None:
                noise = self.draw_noise(batch, pose_batch, generator)
            body, idx = ts.body, batch.frame_idx
            thetas = body.thetas(idx)  # (P, 72)
            inputs = RenderInputs(
                uv=batch.uv, pose=batch.pose, intrinsics=batch.intrinsics,
                scale=batch.smpl_scale, transl=body.transl[:, idx], thetas=thetas,
                betas=body.betas[:, 0], frame_idx=idx, epoch=ts.epoch,
            )
            out = ts.model.render(self.state, inputs, train=True, noise=noise)
            if ts.epoch > 250:
                out["temporal_loss"] = ((body.thetas(max(idx - 1, 0)) - thetas) ** 2).mean()
            with span("loss.total"):
                loss, logs = total_loss(self.loss_cfg, out, batch.rgb, ts.epoch, sam_mask_logits=batch.sam_mask,
                                        share=share)

            zero = torch.zeros((), device=loss.device)
            d_w, s_w, i_w = zero, zero, zero
            if pose_batch is not None:
                with span("step.pose_losses"):
                    d_raw, s_raw, i_raw = self._pose_step_losses(ts, batch, pose_batch, noise["interp_idx"])
                cfg = self.loss_cfg
                decay = 1.0 - min(float(cfg.depth_loss_milestone), float(ts.epoch)) / cfg.depth_loss_milestone
                d_w = cfg.depth_order_weight * decay * d_raw
                s_w = cfg.silhouette_weight * decay * s_raw
                i_w = cfg.interpenetration_weight * decay * i_raw
                if share is not None:
                    d_w, s_w, i_w = d_w / share.world, s_w / share.world, i_w / share.world
                loss = loss + d_w + s_w + i_w
                logs["loss"] = loss
            logs["pose_depth_order_loss"] = d_w
            logs["pose_silhouette_loss"] = s_w
            logs["pose_interpenetration_loss"] = i_w
            return loss, logs

    def loss_and_grads(self, ts: TrainState, batch: Batch, noise=None, generator=None, pose_batch=None,
                       share=None):
        """(loss, logs, grads): grads by parameter name, zeros where unused."""
        params = ts.params()
        loss, logs = self.forward_loss(ts, batch, noise, generator, pose_batch, share)
        with span("step.backward"):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)
        }
        return loss, logs, grads

    def step(self, ts: TrainState, batch: Batch, noise=None, generator=None, pose_batch=None):
        """One optimization step; updates `ts` in place and returns (ts, logs).
        `pose_batch` (pose-only frames) adds the mesh-based depth-order,
        silhouette and interpenetration losses to the differentiated loss."""
        loss, logs, grads = self.loss_and_grads(ts, batch, noise, generator, pose_batch)
        return self.update(ts, batch.mode, loss, logs, grads)

    def update(self, ts: TrainState, mode: int, loss, logs: dict, grads: dict):
        """The masked Adam update of a step in `mode` from its loss and
        gradients, or none at all where either is non-finite; returns (ts, logs)."""
        with span("step.finite"):
            finite = torch.isfinite(loss) & torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        lr_now = multistep_lr(self.lr, ts.epoch, self.milestones, self.gamma)
        if _host_wait(finite):  # otherwise drop the whole update, optimizer state included
            with span("step.update"):
                params = ts.params()
                masks = _active_masks(params, mode)
                joint = {k: a and mode != MODE_POSE_ONLY for k, a in masks.items()}
                ts.opt_joint = adam_update(
                    grads, ts.opt_joint, params, lr_now, make_lr_factors(params), joint
                )
                body = {k: p for k, p in params.items() if k.startswith("body.")}
                pose = {k: masks[k] and mode == MODE_POSE_ONLY for k in body}
                ts.opt_pose = adam_update(
                    grads, ts.opt_pose, body, lr_now, {k: 0.1 for k in body}, pose
                )
        logs = {k: v.detach() if torch.is_tensor(v) else v for k, v in logs.items()}
        logs["lr"] = lr_now
        logs["update_skipped"] = 0.0 if _host_wait(finite) else 1.0
        return ts, logs
