"""Keypoint-based SMPL pose, shape and translation refinement.

Counterpart of `multiply_tpu/preprocessing/refine.py`: per frame, 150 Adam
iterations fit each person's SMPL parameters to 2D keypoints (ViTPose COCO-17
or OpenPose BODY_25) with a GMoF-robust reprojection loss and a rot6D
temporal term against the previous frame's refined pose.

Where JAX vmaps one optimizer per person, the port runs one batched person
axis: the per-person body tensors are stacked (genders may differ), the
per-person losses are summed, so each person's gradient is that person's
loss alone, and Adam (`engine/optim.py`, optax's `adam(lr, eps=1e-8)`) acts
entry by entry. The iterations stay on the device with no host
synchronisation; the frame chain runs on the host, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..body.server import SMPLServer, smpl_server_forward
from ..engine.optim import adam_init, adam_update
from .rotations import axis_angle_to_rot6d

# SMPL all-joints (24 joints + nose, reye, leye, rear, lear) -> COCO-17
SMPL_TO_COCO17 = np.array([24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8])
# -> OpenPose BODY_25; -1 has no SMPL counterpart and weighs 0
SMPL_TO_OPENPOSE25 = np.array([24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                               25, 26, 27, 28, -1, -1, -1, -1, -1, -1])
# the 25-keypoint loss ignores the neck and the hips
OPENPOSE_IGNORED = (1, 9, 12)


class GMoF(NamedTuple):
    rho: float = 100.0

    def __call__(self, residual: torch.Tensor) -> torch.Tensor:
        sq = residual**2
        return self.rho**2 * sq / (sq + self.rho**2)


def project(points: torch.Tensor, K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) world -> (..., N, 2) pixels with K (3, 3), extrinsic R (3, 3), t (3,)."""
    pix = (points @ R.T + t) @ K.T
    return pix[..., :2] / pix[..., 2:3].clamp_min(1e-8)


class RefineConfig(NamedTuple):
    iters: int = 150
    lr: float = 0.02
    rho: float = 100.0
    j2d_weight: float = 1e-2
    temporal_weight: float = 6.0
    is_vitpose: bool = True


def joint_map_and_weights(is_vitpose: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices into SMPL's all-joints and the weight of each keypoint."""
    if is_vitpose:
        return torch.as_tensor(SMPL_TO_COCO17, device=device), torch.ones(17, device=device)
    weights = np.ones(25, np.float32)
    weights[list(OPENPOSE_IGNORED)] = 0.0
    weights[SMPL_TO_OPENPOSE25 < 0] = 0.0
    return (torch.as_tensor(np.maximum(SMPL_TO_OPENPOSE25, 0), device=device),
            torch.as_tensor(weights, device=device))


def person_losses(server: SMPLServer, params: dict, K, R, t, keypoints_2d, last_pose, joint_map, joint_weights,
                  cfg: RefineConfig) -> torch.Tensor:
    """(P,) refinement loss of each person of a stacked server."""
    P = params["pose"].shape[0]
    out = smpl_server_forward(server, torch.ones(P, device=params["pose"].device), params["transl"],
                              params["pose"], params["betas"])
    pix = project(out["smpl_all_jnts"][:, joint_map], K, R, t)
    conf = keypoints_2d[..., 2] * joint_weights
    j2d = (conf[..., None] ** 2 * GMoF(cfg.rho)(keypoints_2d[..., :2] - pix)).mean((-2, -1))
    rot6d = axis_angle_to_rot6d(torch.stack([last_pose, params["pose"]]).reshape(2, P, 24, 3))
    temporal = (rot6d[0] - rot6d[1]).square().mean((-2, -1))
    return cfg.j2d_weight * j2d + cfg.temporal_weight * temporal


def refine_frame(server: SMPLServer, K, R, t, init_pose, init_transl, init_betas, keypoints_2d, last_pose,
                 cfg: RefineConfig = RefineConfig()):
    """One frame's refinement of every person of a stacked server: ((pose (P,
    72), transl (P, 3), betas (P, 10)), losses (P, iters)). The inputs are
    tensors on the server's device: init_* (P, ...), keypoints_2d (P, J, 3)
    as x, y, confidence, last_pose (P, 72) the previous frame's refined pose."""
    joint_map, joint_weights = joint_map_and_weights(cfg.is_vitpose, keypoints_2d.device)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in (("pose", init_pose), ("transl", init_transl), ("betas", init_betas))}
    state = adam_init(params)
    ones, active = dict.fromkeys(params, 1.0), dict.fromkeys(params, True)
    losses = []
    for _ in range(cfg.iters):
        loss = person_losses(server, params, K, R, t, keypoints_2d, last_pose, joint_map, joint_weights, cfg)
        grads = dict(zip(params, torch.autograd.grad(loss.sum(), list(params.values()))))
        state = adam_update(grads, state, params, cfg.lr, ones, active)
        losses.append(loss.detach())
    return tuple(params[k].detach() for k in ("pose", "transl", "betas")), torch.stack(losses, dim=-1)


def refine_sequence(server: SMPLServer, K, R, t, poses, transl, betas, keypoints_2d,
                    cfg: RefineConfig = RefineConfig()):
    """Frame-chained refinement: each frame's temporal term is against the
    previous refined frame (the first against its own initial pose), every
    frame starts from the given betas. poses (F, P, 72), transl (F, P, 3),
    betas (P, 10), keypoints_2d (F, P, J, 3) -> (poses, transl, mean over
    frames of the refined betas)."""
    out_poses, out_transl, out_betas = [], [], []
    last = poses[0]
    for f in range(poses.shape[0]):
        (pose, tr, be), _ = refine_frame(server, K, R, t, poses[f], transl[f], betas, keypoints_2d[f], last, cfg)
        out_poses.append(pose)
        out_transl.append(tr)
        out_betas.append(be)
        last = pose
    return torch.stack(out_poses), torch.stack(out_transl), torch.stack(out_betas).mean(0)
