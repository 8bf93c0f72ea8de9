"""Rotation conversions (axis-angle, matrix, 6D) on tensors.

Counterpart of `multiply_tpu/preprocessing/rotations.py`: the subset that the
keypoint refinement's rot6D temporal loss uses. The 6D form is a matrix's
first two columns, written row by row (Zhou et al.).
"""

from __future__ import annotations

import torch

from ..body.smpl import rodrigues

axis_angle_to_matrix = rodrigues


def matrix_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): first two columns, row-major."""
    return R[..., :3, :2].transpose(-1, -2).reshape(*R.shape[:-2], 6)


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt."""
    a1, a2 = d6[..., 0:3], d6[..., 3:6]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True).clamp_min(1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)  # b_i are the columns of R


def matrix_to_axis_angle(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) axis-angle, the cosine clipped to 1 - eps from
    either end so that 0 and pi stay finite."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    angle = torch.arccos(((trace - 1.0) / 2.0).clamp(-1.0 + eps, 1.0 - eps))
    axis = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    axis = axis / (2.0 * torch.sin(angle)[..., None]).clamp_min(eps)
    return axis * angle[..., None]


def axis_angle_to_rot6d(aa: torch.Tensor) -> torch.Tensor:
    return matrix_to_rot6d(axis_angle_to_matrix(aa))
