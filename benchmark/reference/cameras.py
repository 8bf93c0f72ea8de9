"""Projection-matrix decomposition and ray generation from pinhole cameras.

Counterpart of `multiply_tpu/utils/cameras.py`. `load_K_Rt_from_P` is an RQ
decomposition (scipy) with OpenCV's sign convention, in place of
`cv2.decomposeProjectionMatrix`; the rest is torch.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch


def load_K_Rt_from_P(P: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decompose a 3x4 projection matrix into intrinsics (4x4, K / K[2, 2]) and
    the camera-to-world pose (4x4), float32, as `cv2.decomposeProjectionMatrix`
    does: P[:, :3] = K R with R a rotation and K[0, 0], K[1, 1] positive (K[2, 2]
    takes the sign of det P[:, :3]), and the camera centre is the null vector of P."""
    P = np.asarray(P, np.float64)[:3, :4]
    K, R = scipy.linalg.rq(P[:, :3])
    signs = np.where(np.diag(K) < 0, -1.0, 1.0)
    if np.prod(signs) * np.linalg.det(R) < 0:
        signs[2] = -signs[2]
    K, R = K * signs[None, :], signs[:, None] * R
    centre = np.linalg.svd(np.concatenate([P, np.zeros((1, 4))]))[2][-1]

    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = centre[:3] / centre[3]
    return intrinsics, pose


def lift(x, y, z, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject pixel coords to homogeneous camera-space points."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    sk = intrinsics[0, 1]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), normalised here -> (3, 3) rotation."""
    q = q / torch.linalg.norm(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]),
    ])


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation -> unit quaternion (w, x, y, z); single-branch formula,
    which assumes trace(R) > -1 (camera poses near identity)."""
    w = torch.sqrt(torch.clamp_min(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    return torch.stack([
        w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w),
    ])


def pose_from_quat7(pose7: torch.Tensor) -> torch.Tensor:
    """(7,) [quaternion wxyz | camera location] -> (4, 4) camera-to-world."""
    top = torch.cat([quat_to_rot(pose7[:4]), pose7[4:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=pose7.dtype, device=pose7.device)
    return torch.cat([top, bottom])


def get_camera_params(
    uv: torch.Tensor,  # (N, 2) pixel coordinates
    pose: torch.Tensor,  # (4, 4) camera-to-world, or (7,) [quaternion | location]
    intrinsics: torch.Tensor,  # (3, 3) or (4, 4)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel coords -> world-space unit ray directions (N, 3) + camera location (3,)."""
    if pose.dim() == 1:
        pose = pose_from_quat7(pose)
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
