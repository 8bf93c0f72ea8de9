"""Mesh-over-image visualisation: each person's mesh drawn over the training
frames with the training cameras.

Counterpart of `multiply_tpu/engine/visualize.py`: the host z-buffer
(`native.rasterize_depth`) draws each person's mesh with double-sided
Lambertian face shading in the person's tint, the nearest person wins a
pixel, and the result is blended over the frame. Frames go out as PNGs
(`utils/io.write_png`) and a looping GIF (`utils/io.write_gif`).
"""

from __future__ import annotations

import os

import numpy as np

from ..native import rasterize_depth
from ..utils.io import write_gif, write_png
from .instance_masks import project_depth

PERSON_TINTS = np.array([[0.9, 0.4, 0.35], [0.35, 0.5, 0.9], [0.4, 0.85, 0.4], [0.85, 0.8, 0.3]])


def shade_mesh_over_image(image: np.ndarray, meshes: list[tuple[np.ndarray, np.ndarray]], P: np.ndarray,
                          alpha: float = 0.85, light_dir=(0.3, -0.5, -0.8)) -> np.ndarray:
    """(H, W, 3) float image in [0, 1] with the meshes [(verts, faces)] of the
    persons drawn over it through the (3 | 4, 4) projection P."""
    H, W = image.shape[:2]
    out = image.copy()
    light = np.asarray(light_dir, np.float32)
    light /= np.linalg.norm(light)
    composite_depth = np.full((H, W), np.inf, np.float32)
    composite_rgb = np.zeros((H, W, 3), np.float32)
    hit_any = np.zeros((H, W), bool)
    for pid, (verts, faces) in enumerate(meshes):
        depth, fid = rasterize_depth(project_depth(P, verts).astype(np.float32), faces, W, H, return_face_id=True)
        hit = np.isfinite(depth)
        if not hit.any():
            continue
        tri = verts[faces]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        shade = 0.35 + 0.65 * np.abs(n @ light)
        color = PERSON_TINTS[pid % len(PERSON_TINTS)][None, :] * shade[:, None]
        px = hit & (depth < composite_depth)
        composite_depth[px] = depth[px]
        composite_rgb[px] = color[fid[px]]
        hit_any |= hit
    out[hit_any] = (1 - alpha) * out[hit_any] + alpha * composite_rgb[hit_any]
    return out


def export_visualization(out_dir: str, images: list[np.ndarray], meshes_per_frame: list[list[tuple]],
                         P_per_frame: list[np.ndarray], gif: bool = True) -> None:
    """<out_dir>/%04d.png for each frame and, with `gif`, sequence.gif at 10
    frames a second."""
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i, (img, meshes, P) in enumerate(zip(images, meshes_per_frame, P_per_frame)):
        u8 = (np.clip(shade_mesh_over_image(img, meshes, P), 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f"{i:04d}.png"), u8)
        frames.append(u8)
    if gif and frames:
        write_gif(os.path.join(out_dir, "sequence.gif"), frames, fps=10)
