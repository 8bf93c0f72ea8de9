"""Per-frame optimizable SMPL parameter tables.

Counterpart of `multiply_tpu/body/params.py`. The table is an `nn.Module`
whose parameters carry an optional leading person axis: betas (P, 1, 10),
global_orient (P, F, 3), transl (P, F, 3), body_pose (P, F, 69).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class BodyParamTable(nn.Module):
    def __init__(self, betas, global_orient, transl, body_pose):
        super().__init__()
        self.betas = nn.Parameter(betas)
        self.global_orient = nn.Parameter(global_orient)
        self.transl = nn.Parameter(transl)
        self.body_pose = nn.Parameter(body_pose)

    @staticmethod
    def create(
        num_frames: int, betas=None, global_orient=None, transl=None, body_pose=None,
        device="cuda",
    ) -> "BodyParamTable":
        """One person's table; missing entries start at zero."""

        def arr(x, shape):
            if x is None:
                return torch.zeros(shape, device=device)
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device).reshape(shape)

        return BodyParamTable(
            arr(betas, (1, 10)),
            arr(global_orient, (num_frames, 3)),
            arr(transl, (num_frames, 3)),
            arr(body_pose, (num_frames, 69)),
        )

    @staticmethod
    def stack(tables: list["BodyParamTable"]) -> "BodyParamTable":
        """Stack per-person tables along a new leading person axis."""
        return BodyParamTable(
            *(
                torch.stack([getattr(t, k).detach() for t in tables])
                for k in ("betas", "global_orient", "transl", "body_pose")
            )
        )

    def thetas(self, frame_idx: int) -> torch.Tensor:
        """Full 72-d pose (global orient + body pose) for a frame: (..., 72)."""
        return torch.cat(
            [self.global_orient[..., frame_idx, :], self.body_pose[..., frame_idx, :]], dim=-1
        )
