"""Triangle-mesh geometry: point-triangle distance, winding-number sign, the
baked signed-distance grid, its trilinear lookup, ray-mesh (hard and soft-min
depth) and ray-box tests.

Counterpart of `multiply_tpu/ops/mesh_ops.py`. Every point x face product is
tiled over points and faces, so peak memory stays chunk x face_chunk.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint


# rays x faces of one ray chunk's face tile on a GPU (2048 rays against a 4096-face
# tile, 1024 against a full 8192-face one): a checkpointed chunk's backward holds
# a few hundred bytes an element at its peak
CUDA_TILE_ELEMS = 2048 * 4096


def _dot(a, b):
    return (a * b).sum(-1)


def point_triangle_distance_sq(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Exact squared distance from points (..., 3) to triangles (..., 3, 3)
    (Ericson RTCD 5.1.5), broadcasting over the leading axes."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    w_bc = ((d4 - d3) / ((d4 - d3) + (d5 - d6)).clamp_min(1e-30)).clamp(0.0, 1.0)
    v_ab = (d1 / (d1 - d3).clamp_min(1e-30)).clamp(0.0, 1.0)
    w_ac = (d2 / (d2 - d6).clamp_min(1e-30)).clamp(0.0, 1.0)

    denom_in = (va + vb + vc).clamp_min(1e-30)
    q = a + (vb / denom_in)[..., None] * ab + (vc / denom_in)[..., None] * ac
    q_ab = a + v_ab[..., None] * ab
    q_ac = a + w_ac[..., None] * ac
    q_bc = b + w_bc[..., None] * (c - b)

    # region select in reverse of the RTCD early-return order
    def sel(cond, x, y):
        return torch.where(cond[..., None], x, y)

    q = sel((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), q_bc, q)
    q = sel((vb <= 0) & (d2 >= 0) & (d6 <= 0), q_ac, q)
    q = sel((d6 >= 0) & (d5 <= d6), c.expand_as(q), q)
    q = sel((vc <= 0) & (d1 >= 0) & (d3 <= 0), q_ab, q)
    q = sel((d3 >= 0) & (d4 <= d3), b.expand_as(q), q)
    q = sel((d1 <= 0) & (d2 <= 0), a.expand_as(q), q)
    d = p - q
    return _dot(d, d)


def _solid_angle(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Signed solid angle subtended by triangles (..., 3, 3) at points (..., 3)."""
    a = tri[..., 0, :] - p
    b = tri[..., 1, :] - p
    c = tri[..., 2, :] - p
    la, lb, lc = a.norm(dim=-1), b.norm(dim=-1), c.norm(dim=-1)
    num = _dot(a, torch.linalg.cross(b, c))
    den = la * lb * lc + _dot(a, b) * lc + _dot(b, c) * la + _dot(c, a) * lb
    return 2.0 * torch.atan2(num, den)


def signed_distance(
    points: torch.Tensor,  # (N, 3)
    verts: torch.Tensor,  # (V, 3)
    faces: torch.Tensor,  # (F, 3) int
    chunk_size: int = 512,
    face_chunk: int = 8192,
) -> torch.Tensor:
    """Exact signed distance to a closed mesh, negative inside (sign from the
    generalized winding number)."""
    tris = verts[faces]  # (F, 3, 3)
    out = []
    for pc in points.split(chunk_size):
        min_d2 = torch.full((pc.shape[0],), math.inf, dtype=points.dtype, device=points.device)
        wind = torch.zeros((pc.shape[0],), dtype=points.dtype, device=points.device)
        for tile in tris.split(face_chunk):
            p = pc[:, None, :]
            t = tile[None]
            min_d2 = torch.minimum(min_d2, point_triangle_distance_sq(p, t).min(-1).values)
            wind = wind + _solid_angle(p, t).sum(-1)
        inside = wind / (4.0 * math.pi) > 0.5
        out.append(torch.where(inside, -1.0, 1.0) * torch.sqrt(min_d2))
    return torch.cat(out)


def sdf_grid(verts, faces, res: int = 64, padding: float = 0.2, chunk_size: int = 2048) -> dict:
    """Bake a signed-distance voxel grid around a mesh:
    {"grid": (res, res, res), "origin": (3,), "spacing": (3,)}."""
    with torch.no_grad():
        lo = verts.min(0).values - padding
        hi = verts.max(0).values + padding
        axes = [torch.linspace(0.0, 1.0, res, device=verts.device) for _ in range(3)]
        axes = [lo[i] * (1.0 - t) + hi[i] * t for i, t in enumerate(axes)]
        grid_pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
        vals = signed_distance(grid_pts, verts, faces, chunk_size=chunk_size)
    return {"grid": vals.reshape(res, res, res), "origin": lo, "spacing": (hi - lo) / (res - 1)}


def grid_query(grid: dict, points: torch.Tensor) -> torch.Tensor:
    """Trilinear SDF lookup (N, 3) -> (N,); out-of-grid points clamp to the border."""
    g = grid["grid"]
    res = g.shape[0]
    x = (points - grid["origin"]) / grid["spacing"]
    x = x.clamp(0.0, res - 1 - 1e-6)
    i0f = torch.floor(x)
    f = x - i0f
    i0 = i0f.long()
    i1 = (i0 + 1).clamp_max(res - 1)

    def gat(ix, iy, iz):
        return g[ix, iy, iz]

    c000 = gat(i0[:, 0], i0[:, 1], i0[:, 2])
    c001 = gat(i0[:, 0], i0[:, 1], i1[:, 2])
    c010 = gat(i0[:, 0], i1[:, 1], i0[:, 2])
    c011 = gat(i0[:, 0], i1[:, 1], i1[:, 2])
    c100 = gat(i1[:, 0], i0[:, 1], i0[:, 2])
    c101 = gat(i1[:, 0], i0[:, 1], i1[:, 2])
    c110 = gat(i1[:, 0], i1[:, 1], i0[:, 2])
    c111 = gat(i1[:, 0], i1[:, 1], i1[:, 2])

    fx, fy, fz = f.unbind(-1)
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def _ray_chunk_hits(oc, dc, tris, soft_tau: float, face_chunk: int):
    """One chunk of rays against all faces: (t_min, hit, t_soft), each (C,).
    Running minimum and streaming logsumexp over face tiles."""
    BIG, NEG = 1e10, -1e30
    C = oc.shape[0]
    kw = dict(dtype=tris.dtype, device=tris.device)
    t_min = torch.full((C,), BIG, **kw)
    m = torch.full((C,), NEG, **kw)
    s = torch.zeros((C,), **kw)
    ts = torch.zeros((C,), **kw)
    d = dc[:, None, :]
    for tile in tris.split(face_chunk):
        v0 = tile[None, :, 0]
        e1 = tile[None, :, 1] - v0
        e2 = tile[None, :, 2] - v0
        pvec = torch.linalg.cross(d, e2)
        det = (e1 * pvec).sum(-1)
        # a zero-area (padding) face has det == 0: no hit, and no 1/0 in the backward
        nondeg = det.abs() > 1e-9
        inv_det = torch.where(nondeg, 1.0 / torch.where(nondeg, det, 1.0), 0.0)
        tvec = oc[:, None, :] - v0
        u = (tvec * pvec).sum(-1) * inv_det
        qvec = torch.linalg.cross(tvec, e1)
        v = (d * qvec).sum(-1) * inv_det
        t = (e2 * qvec).sum(-1) * inv_det
        valid = nondeg & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
        t_min = torch.minimum(t_min, torch.where(valid, t, BIG).min(-1).values)
        if soft_tau > 0:
            logit = torch.where(valid, -t / soft_tau, NEG)
            new_m = torch.maximum(m, logit.max(-1).values)
            scale = torch.exp(m - new_m)
            e = torch.exp(logit - new_m[:, None])
            s = s * scale + e.sum(-1)
            ts = ts * scale + (e * torch.where(valid, t, 0.0)).sum(-1)
            m = new_m
    hit = t_min < BIG * 0.5
    if soft_tau > 0:
        t_soft = torch.where(hit & (s > 0), ts / s.clamp_min(1e-30), 0.0)
    else:
        t_soft = torch.where(hit, t_min, 0.0)
    return t_min, hit, t_soft


def ray_mesh_intersect(ray_o, ray_d, verts, faces, soft_tau: float = 0.0,
                       chunk_size: int | None = None, face_chunk: int = 8192) -> dict:
    """Front-hit depth per ray (Moller-Trumbore): {"t": (R,) (1e10 on a miss),
    "hit": (R,) bool, "t_soft": (R,) the softmin-blended depth over all hit
    faces when soft_tau > 0 (else t), 0 on a miss}. Differentiable w.r.t.
    `verts`. When a gradient is wanted each ray chunk is checkpointed, so the
    backward keeps no (chunk x face tile x 3) intermediate alive.

    `chunk_size` None: 256 rays on the CPU; on a GPU as many rays as keep a
    chunk x face tile at CUDA_TILE_ELEMS, since there a chunk's forward,
    recompute and backward cost launches more than arithmetic."""
    tris = verts[faces]
    if chunk_size is None:
        tile = min(tris.shape[0], face_chunk)
        chunk_size = 256 if tris.device.type == "cpu" else max(256, CUDA_TILE_ELEMS // max(tile, 1))
    remat = torch.is_grad_enabled() and (tris.requires_grad or ray_o.requires_grad or ray_d.requires_grad)
    out = []
    for oc, dc in zip(ray_o.split(chunk_size), ray_d.split(chunk_size)):
        if remat:
            out.append(checkpoint(_ray_chunk_hits, oc, dc, tris, soft_tau, face_chunk,
                                  use_reentrant=False, preserve_rng_state=False))  # nothing random inside
        else:
            out.append(_ray_chunk_hits(oc, dc, tris, soft_tau, face_chunk))
    t, hit, t_soft = (torch.cat(x) for x in zip(*out))
    return {"t": t, "hit": hit, "t_soft": t_soft}


def ray_aabb_range(ray_o, ray_d, lo, hi):
    """Slab test of rays (R, 3) against boxes lo/hi (..., 3):
    (t_near, t_far, hit), each (..., R)."""
    inv = 1.0 / torch.where(ray_d.abs() < 1e-9, torch.full_like(ray_d, 1e-9), ray_d)
    t0 = (lo[..., None, :] - ray_o) * inv
    t1 = (hi[..., None, :] - ray_o) * inv
    tmin = torch.minimum(t0, t1).max(-1).values.clamp_min(0.0)
    tmax = torch.maximum(t0, t1).min(-1).values
    return tmin, tmax, tmax >= tmin
