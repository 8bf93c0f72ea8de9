"""Epoch-end instance-mask stage: rasterize each person's posed mesh in every
frame, keep the pixels where that person is in front, project the first 27
joints (24 SMPL + nose + eyes), and write the stage's files for the SAM stage
and the data layer:

    stage_instance_mask/<epoch>/all_person_smpl_mask.npy  (F, P, H, W) bool
    stage_instance_mask/<epoch>/2d_keypoint.npy           (F, P, 27, 2) int32

Counterpart of `multiply_tpu/engine/instance_masks.py`, with
`build_sam_prompts`, which turns one frame's files into the SAM stage's point,
box and mask-prior prompts. The depth maps come from the host C++ z-buffer
(`native.rasterize_depth`).
"""

from __future__ import annotations

import os

import numpy as np

from ..native import rasterize_depth
from ..utils.io import atomic_np_save
from ..utils.resize import resize_linear

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


def build_sam_prompts(instance_masks: np.ndarray, keypoints: np.ndarray, rng: np.random.Generator) -> list[dict]:
    """Per person of one frame ((P, H, W) bool masks, (P, 27, 2) keypoints):
    {"points", "labels", "box", "mask_prior_logits"}, drawing from `rng` as
    the JAX package does. Positive points are the person's keypoints inside
    its mask (else one random mask pixel); negatives are 10 random pixels off
    the mask and the other persons' keypoints on their own masks. The box is
    the mask's, widened by 3%; the prior is the mask on a square canvas
    (top-left, as the predictor pads the frame), resized to 256 x 256 with
    OpenCV's uint8 rule and turned into logits of +-13.8."""
    P, H, W = instance_masks.shape
    prompts = []
    for pid in range(P):
        mask = instance_masks[pid]
        others = np.delete(instance_masks, pid, axis=0)
        neg_mask = others.max(axis=0) if len(others) else np.zeros_like(mask)

        idx = np.argwhere(mask)
        if len(idx) == 0:
            idx = np.asarray([[H // 2, W // 2]])
        x_min, y_min = idx[:, 1].min(), idx[:, 0].min()
        x_max, y_max = idx[:, 1].max(), idx[:, 0].max()
        x_min = max(0, x_min - int(0.03 * (x_max - x_min)))
        y_min = max(0, y_min - int(0.03 * (y_max - y_min)))
        x_max = min(W, x_max + int(0.03 * (x_max - x_min)))
        y_max = min(H, y_max + int(0.03 * (y_max - y_min)))
        box = np.asarray([x_min, y_min, x_max, y_max])

        side = max(H, W)
        canvas = np.zeros((side, side), np.uint8)
        canvas[:H, :W] = mask
        prior = resize_linear(canvas, (256, 256)).astype(np.float32)
        eps = 1e-6
        prior_logit = np.log(np.clip(prior, eps, 1 - eps) / np.clip(1 - prior, eps, 1 - eps))

        kp_int = np.round(np.asarray(keypoints[pid], np.float64)).astype(np.int64)
        pos = [p for p in kp_int if 0 <= p[1] < H and 0 <= p[0] < W and mask[p[1], p[0]] > 0.7]
        if not pos:
            ys, xs = np.nonzero(mask)
            if len(xs):
                j = rng.integers(0, len(xs))
                pos = [np.asarray([xs[j], ys[j]])]
            else:
                pos = [kp_int[-1]]

        neg = []
        tries = 0
        while len(neg) < 10 and tries < 10_000:
            x, y = rng.integers(0, W), rng.integers(0, H)
            tries += 1
            if not mask[y, x]:
                neg.append([x, y])
        for other in range(P):
            if other == pid:
                continue
            for p in np.round(np.asarray(keypoints[other], np.float64)).astype(np.int64):
                if 0 <= p[1] < H and 0 <= p[0] < W and mask[p[1], p[0]] < 0.7 and neg_mask[p[1], p[0]] > 0.7:
                    neg.append([int(p[0]), int(p[1])])

        prompts.append({
            "points": np.asarray(list(pos) + neg, np.float32),
            "labels": np.concatenate([np.ones(len(pos)), np.zeros(len(neg))]).astype(np.int32),
            "box": box.astype(np.float32),
            "mask_prior_logits": prior_logit,
        })
    return prompts
