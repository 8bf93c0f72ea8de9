"""Point sampling for eikonal and bone supervision.

Counterpart of `multiply_tpu/ops/point_sampler.py`: a gaussian-local sample
per input point plus a share of uniform global samples, points along the
kinematic tree's bones with their occupancy target, and the joints with
one-hot skinning weights. Randomness is explicit: each sampler takes its
draws as `noise` (standard normals, uniforms in [0, 1)) or draws them from a
`torch.Generator`, so a test can hand in the numbers `jax.random` drew.
"""

from __future__ import annotations

import torch

from ..body.smpl import SMPL_PARENTS


def default_bone_ids(device="cpu") -> torch.Tensor:
    """(B, 2) [parent, child] pairs of the SMPL kinematic tree (root excluded)."""
    parents = torch.as_tensor(SMPL_PARENTS, device=device)
    return torch.stack([parents[1:], torch.arange(1, len(SMPL_PARENTS), device=device)], dim=-1)


def sample_points_in_space(pc_input: torch.Tensor, local_sigma: float = 0.01, global_sigma: float = 0.5,
                           global_ratio: float = 0.125, noise: dict | None = None,
                           generator: torch.Generator | None = None) -> torch.Tensor:
    """One gaussian-local sample per (N, 3) center, then int(N * global_ratio)
    uniform points in the [-global_sigma, global_sigma] cube. `noise` holds
    "normal" (N, 3) and "uniform" (N_global, 3) in [0, 1)."""
    n, d = pc_input.shape
    n_global = int(n * global_ratio)
    if noise is None:
        kw = dict(generator=generator, device=pc_input.device, dtype=pc_input.dtype)
        noise = {"normal": torch.randn((n, d), **kw), "uniform": torch.rand((n_global, d), **kw)}
    local = pc_input + noise["normal"] * local_sigma
    if n_global == 0:
        return local
    lo = torch.tensor(-global_sigma, dtype=pc_input.dtype, device=pc_input.device)
    glob = torch.maximum(lo, noise["uniform"] * (2 * global_sigma) + lo)
    return torch.cat([local, glob], dim=0)


def sample_points_on_bones(joints: torch.Tensor, bone_ids: torch.Tensor | None = None, num_per_bone: int = 5,
                           jitter: float = 0.001, noise: torch.Tensor | None = None,
                           generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Points along each bone of (J, 3) joints: (samples (B * n, 3), occupancy
    targets (B * n,) of 0.01). `noise` is the (B, n) standard-normal jitter of
    the positions along the bones, each clipped to [0, 1]."""
    if bone_ids is None:
        bone_ids = default_bone_ids(joints.device)
    B = bone_ids.shape[0]
    if noise is None:
        noise = torch.randn((B, num_per_bone), generator=generator, device=joints.device, dtype=joints.dtype)
    starts = joints[bone_ids[:, 0]]
    dirs = joints[bone_ids[:, 1]] - starts
    t = torch.linspace(0.0, 1.0, num_per_bone, dtype=joints.dtype, device=joints.device)[None, :]
    t = (t + noise * jitter).clamp(0.0, 1.0)
    samples = (starts[:, None, :] + t[..., None] * dirs[:, None, :]).reshape(-1, 3)
    return samples, torch.full((samples.shape[0],), 0.01, dtype=joints.dtype, device=joints.device)


def sample_joints(joints: torch.Tensor, bone_ids: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint positions with one-hot skinning weights: every joint weighted to
    itself, then every bone's child joint weighted to the bone's parent."""
    if bone_ids is None:
        bone_ids = default_bone_ids(joints.device)
    eye = torch.eye(joints.shape[0], dtype=joints.dtype, device=joints.device)
    samples = torch.cat([joints, joints[bone_ids[:, 1]]], dim=0)
    return samples, torch.cat([eye, eye[bone_ids[:, 0]]], dim=0)
