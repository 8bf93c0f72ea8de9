"""Canonical-space SMPL server: scaled/translated posed bodies and bone
transforms relative to the canonical legs-spread pose.

Counterpart of `multiply_tpu/body/server.py`. A server stacked over persons
(`stack_servers`) runs all persons in one `smpl_server_forward` call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .smpl import NUM_JOINTS, BodyModel, lbs


def canonical_pose_params(dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The 72-d canonical pose: zero except legs spread by +-30 degrees."""
    thetas = torch.zeros(NUM_JOINTS * 3, dtype=dtype, device=device)
    thetas[5] = math.pi / 6
    thetas[8] = -math.pi / 6
    return thetas


class SMPLServer(NamedTuple):
    """Per-person canonical state; stack over persons with `stack_servers`."""

    model: BodyModel
    betas: torch.Tensor  # (..., 10)
    verts_c: torch.Tensor  # (..., V, 3) canonical posed verts
    joints_c: torch.Tensor  # (..., J, 3)
    tfs_c_inv: torch.Tensor  # (..., J, 4, 4) inverse canonical bone transforms
    weights_c: torch.Tensor  # (..., V, J)

    @staticmethod
    def create(model: BodyModel, betas=None, v_template=None) -> "SMPLServer":
        device = model.v_template.device
        betas = (
            torch.zeros(10, device=device)
            if betas is None
            else torch.as_tensor(betas, dtype=torch.float32, device=device)
        )
        out = lbs(model, betas, canonical_pose_params(device=device), v_template=v_template)
        return SMPLServer(
            model=model,
            betas=betas,
            verts_c=out["verts"],
            joints_c=out["joints"],
            tfs_c_inv=torch.linalg.inv(out["A"]),
            weights_c=out["W"],
        )


def smpl_server_forward(
    server: SMPLServer,
    scale: torch.Tensor,  # (...) per body
    transl: torch.Tensor,  # (..., 3)
    thetas: torch.Tensor,  # (..., 72)
    betas: torch.Tensor | None = None,  # (..., 10)
    absolute: bool = False,
) -> dict:
    """Posed SMPL in world units: verts (..., V, 3), jnts, all_jnts and bone
    transforms tfs (..., J, 4, 4) relative to the canonical pose unless `absolute`."""
    if betas is None:
        betas = server.betas
    out = lbs(server.model, betas, thetas)
    s = scale[..., None, None]
    shift = (transl * scale[..., None])[..., None, :]
    tfs = out["A"]
    tfs = torch.cat(
        [
            torch.cat([tfs[..., :3, :3] * s[..., None], (tfs[..., :3, 3] * s + shift)[..., None]], -1),
            tfs[..., 3:, :],
        ],
        dim=-2,
    )
    if not absolute:
        tfs = tfs @ server.tfs_c_inv
    return {
        "smpl_verts": out["verts"] * s + shift,
        "smpl_jnts": out["joints"] * s + shift,
        "smpl_all_jnts": out["all_joints"] * s + shift,
        "smpl_tfs": tfs,
        "smpl_weights": out["W"],
    }


def stack_servers(servers: list[SMPLServer]) -> SMPLServer:
    """Stack P per-person servers along a new leading person axis."""
    model = BodyModel(*(torch.stack(xs) for xs in zip(*(s.model for s in servers))))
    rest = [torch.stack(xs) for xs in zip(*(tuple(s)[1:] for s in servers))]
    return SMPLServer(model, *rest)
