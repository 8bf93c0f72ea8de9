"""Epoch-end instance-mask stage: rasterize each person's posed mesh in every
frame, keep the pixels where that person is in front, project the first 27
joints (24 SMPL + nose + eyes), and write the stage's files for the SAM stage
and the data layer:

    stage_instance_mask/<epoch>/all_person_smpl_mask.npy  (F, P, H, W) bool
    stage_instance_mask/<epoch>/2d_keypoint.npy           (F, P, 27, 2) int32

Counterpart of `multiply_tpu/engine/instance_masks.py` (its
`build_sam_prompts` belongs to the SAM stage and is not ported yet). The depth
maps come from the host C++ z-buffer (`native.rasterize_depth`).
"""

from __future__ import annotations

import os

import numpy as np

from ..native import rasterize_depth
from ..utils.io import atomic_np_save

NUM_PROMPT_JOINTS = 27


def project_points(P: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(3x4 or 4x4 projection) x (N, 3) -> pixel coordinates (N, 2)."""
    h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=-1)
    uvw = (P[:3, :4] @ h.T).T
    return uvw[:, :2] / uvw[:, 2:3]


def project_depth(P: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Per vertex (x pixel, y pixel, projective depth) for the z-buffer."""
    h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=-1)
    uvw = (P[:3, :4] @ h.T).T
    return np.stack([uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2], uvw[:, 2]], axis=-1)


def render_instance_masks(mesh_per_person: list, joints_per_person: list, P: np.ndarray,
                          img_hw: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """One frame: (instance masks (P, H, W) bool, keypoints (P, 27, 2) int32)
    from posed [(verts, faces)] and posed all-joints (J >= 27, 3) per person."""
    H, W = img_hw
    depth = np.stack([
        rasterize_depth(project_depth(P, verts).astype(np.float32), faces, W, H)
        for verts, faces in mesh_per_person
    ])  # (P, H, W), inf where the person is missed
    hit = np.isfinite(depth)
    front = np.min(np.where(hit, depth, 999.0), axis=0)
    masks = hit & (np.where(hit, depth, -1.0) == front[None])
    kps = [project_points(P, j[:NUM_PROMPT_JOINTS]).astype(np.int32) for j in joints_per_person]
    return masks, np.stack(kps, axis=0)


def run_instance_mask_stage(epoch: int, frames: list[dict], out_dir: str = ".") -> tuple[np.ndarray, np.ndarray]:
    """Render all frames ({"P", "img_size", "meshes", "joints"} each) and write
    the stage's files. Returns (masks, keypoints)."""
    per_frame = [render_instance_masks(fr["meshes"], fr["joints"], fr["P"], fr["img_size"]) for fr in frames]
    masks = np.stack([m for m, _ in per_frame])  # (F, P, H, W)
    kps = np.stack([k for _, k in per_frame])  # (F, P, 27, 2)
    stage = os.path.join(out_dir, "stage_instance_mask", f"{epoch:05d}")
    os.makedirs(stage, exist_ok=True)
    atomic_np_save(os.path.join(stage, "all_person_smpl_mask.npy"), masks)
    atomic_np_save(os.path.join(stage, "2d_keypoint.npy"), kps)
    return masks, kps
