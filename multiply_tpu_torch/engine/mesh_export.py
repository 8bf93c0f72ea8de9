"""Canonical-mesh extraction: the MISE octree (host C++) driving batched SDF
evaluations, marching tetrahedra, the largest connected component, PLY files.

Counterpart of `multiply_tpu/engine/mesh_export.py`. The box is the canonical
SMPL vertices' bounding cube scaled by 1.1; `res_up=2` during training (128^3
effective) and 4 at test time (512^3). `sdf_fn` takes numpy (N, 3) chunks and
returns (N,) values; the trainer's runs the port's `ImplicitNet` on the card.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph

from ..utils.profiling import count


def generate_mesh(
    sdf_fn: Callable[[np.ndarray], np.ndarray],  # (N, 3) -> (N,) canonical SDF
    verts_hint: np.ndarray,  # (V, 3) canonical SMPL verts: define the box
    point_batch: int = 65_536,
    res_init: int = 32,
    res_up: int = 2,
    level: float = 0.0,
    largest_component: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """(verts (V, 3) in the SDF's coordinates, faces (F, 3) int64)."""
    from ..native import MISE, marching_tetrahedra

    verts_hint = np.asarray(verts_hint)
    gt_center = 0.5 * (verts_hint.max(0) + verts_hint.min(0))
    gt_scale = 1.1 * (verts_hint.max(0) - verts_hint.min(0)).max()

    mise = MISE(res_init, res_up, level)
    R = mise.resolution
    while True:
        pts_int = mise.query()
        if len(pts_int) == 0:
            break
        count("mesh.rounds")
        # grid -> world: a centred cube of side gt_scale
        pts = (pts_int.astype(np.float32) / R - 0.5) * gt_scale + gt_center
        vals = [np.asarray(sdf_fn(pts[s : s + point_batch])) for s in range(0, len(pts), point_batch)]
        mise.update(np.concatenate(vals))

    grid = mise.to_dense()
    verts, faces = marching_tetrahedra(grid, level)
    if len(verts) == 0:
        return verts, faces
    verts = (verts / R - 0.5) * gt_scale + gt_center
    if largest_component and len(faces):
        verts, faces = keep_largest_component(verts, faces)
    return verts, faces


def keep_largest_component(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Keep the connected component (vertices joined by faces) with the most
    faces; between components with as many faces, the one whose lowest vertex
    index is lowest. Vertices keep their order."""
    n = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 1]])
    cols = np.concatenate([faces[:, 1], faces[:, 2]])
    graph = scipy.sparse.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    _, labels = scipy.sparse.csgraph.connected_components(graph, directed=False)
    face_labels = labels[faces[:, 0]]
    counts = np.bincount(face_labels, minlength=labels.max() + 1)
    # connected_components numbers components by their lowest vertex, so the
    # first label of the largest count is the tie-break above
    keep_faces = faces[face_labels == np.argmax(counts)]
    used = np.unique(keep_faces)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[keep_faces]


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """ASCII PLY with float x, y, z vertices and triangle faces."""
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        if len(verts):
            np.savetxt(f, np.asarray(verts, np.float64), fmt="%.6f")
        if len(faces):
            np.savetxt(f, np.concatenate([np.full((len(faces), 1), 3), faces], axis=1), fmt="%d")


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """The vertices and triangles of a PLY that `save_ply` wrote."""
    with open(path) as f:
        n_v = n_f = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        verts = [[float(x) for x in next(f).split()[:3]] for _ in range(n_v)]
        faces = [[int(x) for x in next(f).split()[1:4]] for _ in range(n_f)]
    return np.asarray(verts, np.float32).reshape(-1, 3), np.asarray(faces, np.int64).reshape(-1, 3)
