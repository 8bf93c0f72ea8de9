"""Inter-person pose losses: depth ordering, interpenetration, silhouette.

Counterpart of `multiply_tpu/engine/pose_losses.py`. The depth-order and
silhouette terms are evaluated at a sparse set of pixels through
differentiable ray-mesh intersection (`ops/mesh_ops.ray_mesh_intersect`); the
inside test is a generalized winding number; the pull to the partner's
surface is an MSE to the nearest partner vertex.

Every loss is a function of the deformed vertex arrays, so gradients flow
through the deformer and the SMPL forward into the per-frame pose, shape and
translation parameters. Masks are applied with `torch.where` and masked sums:
no boolean indexing, no host synchronisation.
"""

from __future__ import annotations

import math

import torch

from .knn import knn
from .mesh_ops import _solid_angle, ray_mesh_intersect


def winding_inside(points: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
                   chunk_size: int = 512, face_chunk: int = 8192) -> torch.Tensor:
    """Generalized winding number > 0.5 inside test for points (N, 3) against a
    closed mesh: (N,) bool. Tiled over points and faces, so peak memory stays
    chunk x face_chunk; zero-area (padding) faces subtend no solid angle. The
    result carries no gradient."""
    with torch.no_grad():
        tris = verts[faces]
        out = []
        for pc in points.split(chunk_size):
            wind = torch.zeros((pc.shape[0],), dtype=points.dtype, device=points.device)
            for tile in tris.split(face_chunk):
                wind = wind + _solid_angle(pc[:, None, :], tile[None]).sum(-1)
            out.append(wind / (4.0 * math.pi) > 0.5)
        return torch.cat(out)


def draw_interpenetration_samples(verts_counts: list[int], num_samples: int = 5120,
                                  generator: torch.Generator | None = None, device="cuda") -> list[torch.Tensor]:
    """Per person, the vertex indices that `interpenetration_loss` samples."""
    return [
        torch.randint(0, v, (min(num_samples, v),), generator=generator, device=device)
        for v in verts_counts
    ]


def interpenetration_loss(verts_list: list[torch.Tensor], faces_list: list[torch.Tensor],
                          generator: torch.Generator | None = None, num_samples: int = 5120,
                          sample_idx: list[torch.Tensor] | None = None) -> torch.Tensor:
    """Push sampled vertices of each mesh out of every partner mesh: a sample
    inside a partner gets a squared-distance pull to its nearest partner
    vertex, unless that vertex is 0.1 m or more away. `sample_idx` pins each
    person's sampled vertex indices; otherwise they are drawn from `generator`."""
    loss = verts_list[0].new_zeros(())
    P = len(verts_list)
    if sample_idx is None:
        sample_idx = draw_interpenetration_samples(
            [v.shape[0] for v in verts_list], num_samples, generator, verts_list[0].device
        )
    for pid in range(P):
        sample = verts_list[pid][sample_idx[pid]]
        for partner in range(P):
            if partner == pid:
                continue
            verts_p = verts_list[partner]
            inside = winding_inside(sample, verts_p, faces_list[partner])
            with torch.no_grad():
                _, nn_idx = knn(sample, verts_p, k=1)
            neighbor = verts_p[nn_idx[:, 0]]
            sq = ((sample - neighbor) ** 2).sum(-1)
            stable = sq.detach().sqrt() < 0.1
            loss = loss + torch.where(inside & stable, sq, torch.zeros_like(sq)).sum()
    return loss


def _person_depths(ray_o, ray_d, verts_list, faces_list, soft_tau: float, miss: float):
    """Hard and soft front depths (M, P) with `miss` where a ray misses, and the hit mask."""
    ts, ts_soft, hits = [], [], []
    for v, f in zip(verts_list, faces_list):
        out = ray_mesh_intersect(ray_o, ray_d, v, f, soft_tau=soft_tau)
        ts.append(torch.where(out["hit"], out["t"], miss))
        ts_soft.append(torch.where(out["hit"], out["t_soft"], miss))
        hits.append(out["hit"])
    return torch.stack(ts, -1), torch.stack(ts_soft, -1), torch.stack(hits, -1)


def sparse_depth_order_loss(ray_o, ray_d, verts_list, faces_list, sam_probs: torch.Tensor,
                            scale_to_full=1.0, soft_tau: float = 0.01):
    """Depth-order ranking at sampled pixels. For each pixel the front person
    is the argmin of the ray-mesh depths and the owner the argmax of the SAM
    probabilities (M, P); where they disagree and SAM is confident, the term is
    log(1 + exp(d_owner - d_front)), scaled by n_valid / n_sampled
    (`scale_to_full`) to the magnitude of a full-image sum.
    Returns (loss, valid fraction)."""
    depth, depth_soft, _ = _person_depths(ray_o, ray_d, verts_list, faces_list, soft_tau, 999.0)
    front = depth.min(-1).values
    any_hit = front < 999.0

    sam_sum = sam_probs.sum(-1)
    confident = (sam_sum <= 1.0 + 1e-2) & (sam_sum >= 0.7)
    gt_idx = sam_probs.argmax(-1, keepdim=True)
    gt_depth = depth.gather(-1, gt_idx)[:, 0]
    gt_depth_soft = depth_soft.gather(-1, gt_idx)[:, 0]
    valid = any_hit & confident & (gt_depth < 999.0) & (gt_depth != front)

    front_soft = depth_soft.min(-1).values
    per_pixel = torch.log1p(torch.exp((gt_depth_soft - front_soft).clamp(-30.0, 30.0)))
    loss = torch.where(valid, per_pixel, torch.zeros_like(per_pixel)).sum() * scale_to_full
    return loss, valid.float().mean()


PERSON_COLORS = (
    (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
    (0.49, 0.49, 0.0), (0.0, 0.49, 0.49), (0.49, 0.0, 0.49),
    (0.25, 0.0, 0.0), (0.0, 0.25, 0.0), (0.0, 0.0, 0.25),
    (0.125, 0.125, 0.0), (0.0, 0.125, 0.125), (0.125, 0.0, 0.125),
)


def sparse_silhouette_loss(ray_o, ray_d, verts_list, faces_list, sam_probs: torch.Tensor,
                           soft_tau: float = 0.02) -> torch.Tensor:
    """Soft instance-colour render against the SAM-argmax colour at sampled
    pixels: a softmin over the persons' depths plus a background far away,
    L2, differentiable to the deformed vertices."""
    M, P = sam_probs.shape
    _, depth, hit = _person_depths(ray_o, ray_d, verts_list, faces_list, soft_tau, 1e3)
    kw = dict(dtype=depth.dtype, device=depth.device)
    logits = torch.cat([-depth / soft_tau, torch.full((M, 1), -1e3 / soft_tau, **kw)], dim=-1)
    shown = torch.cat([hit, torch.ones((M, 1), dtype=torch.bool, device=hit.device)], dim=-1)
    w = torch.softmax(torch.where(shown, logits, -math.inf), dim=-1)  # (M, P + 1)
    colors = torch.tensor(PERSON_COLORS[:P] + ((0.0, 0.0, 0.0),), **kw)
    rendered = w @ colors

    bg_prob = 1.0 - sam_probs.sum(-1, keepdim=True)
    gt = colors[torch.cat([sam_probs, bg_prob], dim=-1).argmax(-1)]
    return ((rendered - gt) ** 2).mean()


def depth_loss_schedule(weight: float, epoch, milestone: int = 1000) -> float:
    return weight * (1.0 - min(float(milestone), float(epoch)) / milestone)
