"""Ray generation from pinhole cameras.

Counterpart of `multiply_tpu/utils/cameras.py` (`get_camera_params` with a
4x4 camera-to-world pose, `get_sphere_intersections`, `pixel_grid`).
"""

from __future__ import annotations

import numpy as np
import torch


def lift(x, y, z, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject pixel coords to homogeneous camera-space points."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    sk = intrinsics[0, 1]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def get_camera_params(
    uv: torch.Tensor,  # (N, 2) pixel coordinates
    pose: torch.Tensor,  # (4, 4) camera-to-world
    intrinsics: torch.Tensor,  # (3, 3) or (4, 4)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel coords -> world-space unit ray directions (N, 3) + camera location (3,)."""
    if pose.dim() != 2:
        raise NotImplementedError("quaternion camera poses are not ported yet")
    cam_loc = pose[:3, 3]
    z = torch.ones_like(uv[:, 0])
    pts_cam = lift(uv[:, 0], uv[:, 1], z, intrinsics)  # (N, 4)
    world = (pose @ pts_cam.T).T[:, :3]
    ray_dirs = world - cam_loc[None, :]
    ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=-1, keepdim=True)
    return ray_dirs, cam_loc


def get_sphere_intersections(
    cam_loc: torch.Tensor,  # (N, 3)
    ray_dirs: torch.Tensor,  # (N, 3)
    r: float = 1.0,
) -> torch.Tensor:
    """Near/far ray-sphere distances (N, 2), clamped at 0; a miss gives near == far."""
    d = (ray_dirs * cam_loc).sum(-1, keepdim=True)
    under_sqrt = d**2 - ((cam_loc**2).sum(-1, keepdim=True) - r**2)
    sqrt = torch.sqrt(under_sqrt.clamp_min(0.0))
    near_far = torch.cat([-sqrt, sqrt], dim=-1) - d
    return near_far.clamp_min(0.0)


def pixel_grid(width: int, height: int) -> np.ndarray:
    """Full-image (H*W, 2) uv grid in (x, y) order."""
    xs, ys = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32)
