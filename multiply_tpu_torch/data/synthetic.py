"""Synthetic multi-person scene: ground-truth images and masks rendered by
exact ray-mesh intersection of posed synthetic bodies.

Counterpart of `multiply_tpu/data/synthetic.py` (`make_scene`, `sample_rays`),
with the same seeded numpy draws, so both packages build the same scene. The
principal point stays sub-pixel: an integer one sends the centre ray through
the world origin, which is 0/0 in `depth2pts_outside`. Scenes are made anew
on every call; nothing is cached on disk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..body.server import SMPLServer, canonical_pose_params, smpl_server_forward
from ..body.smpl import synthetic_body_model
from ..ops.mesh_ops import ray_mesh_intersect
from ..utils.cameras import get_camera_params, pixel_grid

PERSON_COLORS = np.array([[0.85, 0.3, 0.25], [0.25, 0.4, 0.85], [0.3, 0.8, 0.3]])
BG_COLOR = np.array([0.9, 0.9, 0.85])


class SyntheticScene(NamedTuple):
    images: np.ndarray  # (F, H, W, 3)
    masks: np.ndarray  # (F, H, W, P) per-person visibility
    sam_logits: np.ndarray  # (F, H, W, P) +-8 logits derived from masks
    poses: np.ndarray  # (F, P, 72)
    transl: np.ndarray  # (F, P, 3)
    betas: np.ndarray  # (P, 10)
    scale: np.ndarray  # (P,)
    cam_pose: np.ndarray  # (F, 4, 4)
    intrinsics: np.ndarray  # (3, 3)
    servers: list  # per-person SMPLServer on the scene's device
    height: int
    width: int


def make_scene(num_frames: int = 4, num_persons: int = 2, height: int = 48, width: int = 64,
               seed: int = 0, model=None, device="cuda") -> SyntheticScene:
    rng = np.random.default_rng(seed)
    if model is None:
        model = synthetic_body_model(device=device)
    betas = rng.standard_normal((num_persons, 10)).astype(np.float32) * 0.3
    servers = [SMPLServer.create(model, betas=betas[i]) for i in range(num_persons)]

    # persons side by side, slight motion over frames
    base_x = np.linspace(-0.5, 0.5, num_persons)
    cano = canonical_pose_params(device="cpu").numpy()
    poses = np.tile(cano, (num_frames, num_persons, 1)).astype(np.float32)
    transl = np.zeros((num_frames, num_persons, 3), np.float32)
    for f in range(num_frames):
        for p in range(num_persons):
            transl[f, p, 0] = base_x[p] + 0.05 * np.sin(f * 0.7 + p)
            poses[f, p, 3:] += rng.standard_normal(69).astype(np.float32) * 0.02

    # fixed camera looking down +z from z=-2.5, sub-pixel principal point
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 3] = [0.0, 0.0, -2.5]
    cam_pose = np.tile(cam, (num_frames, 1, 1))
    f_px = 0.9 * width
    intr = np.array(
        [[f_px, 0, width / 2 + 0.37], [0, f_px, height / 2 + 0.23], [0, 0, 1]], np.float32
    )

    uv = torch.as_tensor(pixel_grid(width, height), device=device)
    images = np.zeros((num_frames, height, width, 3), np.float32)
    masks = np.zeros((num_frames, height, width, num_persons), bool)

    def t(x):
        return torch.as_tensor(x, device=device)

    with torch.no_grad():
        for f in range(num_frames):
            ray_d, cam_loc = get_camera_params(uv, t(cam_pose[f]), t(intr))
            ray_o = cam_loc.expand_as(ray_d)
            depth = np.full((uv.shape[0], num_persons), np.inf, np.float32)
            for p in range(num_persons):
                out = smpl_server_forward(
                    servers[p], t(np.float32(1.0)), t(transl[f, p]), t(poses[f, p]), t(betas[p])
                )
                hit = ray_mesh_intersect(ray_o, ray_d, out["smpl_verts"], model.faces)
                d = hit["t"].cpu().numpy()
                d[~hit["hit"].cpu().numpy()] = np.inf
                depth[:, p] = d

            img = np.tile(BG_COLOR, (uv.shape[0], 1)).astype(np.float32)
            any_hit = np.isfinite(depth).any(axis=1)
            front = np.argmin(depth, axis=1)
            img[any_hit] = PERSON_COLORS[front[any_hit]]
            images[f] = img.reshape(height, width, 3)
            vis = np.zeros((uv.shape[0], num_persons), bool)
            vis[any_hit, front[any_hit]] = True
            masks[f] = vis.reshape(height, width, num_persons)

    return SyntheticScene(
        images=images,
        masks=masks,
        sam_logits=np.where(masks, 8.0, -8.0).astype(np.float32),
        poses=poses,
        transl=transl,
        betas=betas,
        scale=np.ones(num_persons, np.float32),
        cam_pose=cam_pose,
        intrinsics=intr,
        servers=servers,
        height=height,
        width=width,
    )


def sample_rays(scene: SyntheticScene, frame: int, n_rays: int, rng: np.random.Generator) -> dict:
    """Weighted ray sampling: 90% inside the union-mask bbox, 10% anywhere.
    Returns numpy arrays uv (R, 2), rgb (R, 3), sam (R, P)."""
    H, W = scene.height, scene.width
    union = scene.masks[frame].any(-1)
    ys, xs = np.nonzero(union)
    if len(xs) == 0:
        xs, ys = np.array([W // 2]), np.array([H // 2])
    x0, x1 = max(xs.min() - 2, 0), min(xs.max() + 2, W - 1)
    y0, y1 = max(ys.min() - 2, 0), min(ys.max() + 2, H - 1)

    n_obj = int(n_rays * 0.9)
    ox = rng.integers(x0, x1 + 1, n_obj)
    oy = rng.integers(y0, y1 + 1, n_obj)
    rx = rng.integers(0, W, n_rays - n_obj)
    ry = rng.integers(0, H, n_rays - n_obj)
    px, py = np.concatenate([ox, rx]), np.concatenate([oy, ry])
    return {
        "uv": np.stack([px, py], axis=-1).astype(np.float32),
        "rgb": scene.images[frame][py, px],
        "sam": scene.sam_logits[frame][py, px],
    }
