"""Linear blend skinning (forward + inverse) and skinning-weight queries.

Counterpart of `multiply_tpu/ops/skinning.py`. A blended affine transform is
kept as 12 rows [r00 r01 r02 t0 | r10 .. t1 | r20 .. t2] of shape (..., 12, N);
its inverse is the closed-form adjugate. Skinning weights come from the
nearest SMPL vertex (`nn1`) and are detached, as in the reference.
"""

from __future__ import annotations

import torch

from .knn import knn
from .nn1 import nn1

OUTLIER_DIST = 0.1  # meters
DIST_CLAMP = 4.0  # squared-distance clamp


def blend_affine_rows(weights: torch.Tensor, tfs: torch.Tensor) -> torch.Tensor:
    """(..., N, J) weights x (..., J, 4, 4) bone transforms -> (..., 12, N) rows."""
    flat = tfs[..., :3, :].flatten(-2)  # (..., J, 12)
    return flat.transpose(-1, -2) @ weights.transpose(-1, -2)


def affine_apply_rows(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply (..., 12, N) affine rows to (..., N, 3) points."""
    m = m.unbind(-2)
    x0, x1, x2 = x.unbind(-1)
    y0 = m[0] * x0 + m[1] * x1 + m[2] * x2 + m[3]
    y1 = m[4] * x0 + m[5] * x1 + m[6] * x2 + m[7]
    y2 = m[8] * x0 + m[9] * x1 + m[10] * x2 + m[11]
    return torch.stack([y0, y1, y2], dim=-1)


def affine_inverse_apply_rows(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply the inverse of (..., 12, N) affine rows to (..., N, 3) points."""
    r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2 = m.unbind(-2)
    b0, b1, b2 = x[..., 0] - t0, x[..., 1] - t1, x[..., 2] - t2
    A = r11 * r22 - r12 * r21
    B = r12 * r20 - r10 * r22
    C = r10 * r21 - r11 * r20
    inv_det = 1.0 / (r00 * A + r01 * B + r02 * C)
    y0 = (A * b0 + (r02 * r21 - r01 * r22) * b1 + (r01 * r12 - r02 * r11) * b2) * inv_det
    y1 = (B * b0 + (r00 * r22 - r02 * r20) * b1 + (r02 * r10 - r00 * r12) * b2) * inv_det
    y2 = (C * b0 + (r01 * r20 - r00 * r21) * b1 + (r00 * r11 - r01 * r10) * b2) * inv_det
    return torch.stack([y0, y1, y2], dim=-1)


def rotation_inverse_rows(m: torch.Tensor) -> torch.Tensor:
    """(..., 12, N) affine rows -> (..., 9, N) rows of R^{-1}."""
    r00, r01, r02, _t0, r10, r11, r12, _t1, r20, r21, r22, _t2 = m.unbind(-2)
    A = r11 * r22 - r12 * r21
    B = r12 * r20 - r10 * r22
    C = r10 * r21 - r11 * r20
    inv_det = 1.0 / (r00 * A + r01 * B + r02 * C)
    return torch.stack(
        [
            A * inv_det, (r02 * r21 - r01 * r22) * inv_det, (r01 * r12 - r02 * r11) * inv_det,
            B * inv_det, (r00 * r22 - r02 * r20) * inv_det, (r02 * r10 - r00 * r12) * inv_det,
            C * inv_det, (r01 * r20 - r00 * r21) * inv_det, (r00 * r11 - r01 * r10) * inv_det,
        ],
        dim=-2,
    )


def covector_apply_rows(r9: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """n[j] = sum_i g[i] M[i, j] for (..., 9, N) rows and (..., N, 3) g: the
    J^{-T} normal transform."""
    r = r9.unbind(-2)
    g0, g1, g2 = g.unbind(-1)
    n0 = g0 * r[0] + g1 * r[3] + g2 * r[6]
    n1 = g0 * r[1] + g1 * r[4] + g2 * r[7]
    n2 = g0 * r[2] + g1 * r[5] + g2 * r[8]
    return torch.stack([n0, n1, n2], dim=-1)


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (..., V, J), idx (..., N, k) -> (..., N, k, J)."""
    n, k = idx.shape[-2:]
    flat = idx.reshape(idx.shape[:-2] + (n * k, 1)).expand(idx.shape[:-2] + (n * k, table.shape[-1]))
    return torch.gather(table, -2, flat).reshape(idx.shape + (table.shape[-1],))


def query_skinning_weights(
    pts: torch.Tensor,  # (..., N, 3) query points (posed or canonical space)
    verts: torch.Tensor,  # (..., V, 3) SMPL verts in the same space
    smpl_weights: torch.Tensor,  # (..., V, J) canonical LBS weights
    k: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Detached nearest-vertex skinning weights (..., N, J) + outlier mask (..., N)."""
    with torch.no_grad():
        pts, verts = pts.detach().contiguous(), verts.detach().contiguous()
        if k == 1:
            # one neighbour: its confidence exp(-d2) / exp(-d2) is exactly 1.0 (d2 is
            # clamped to <= 4, so the exponential is never 0), and the clamp cannot
            # move sqrt(d2) across OUTLIER_DIST
            d2, idx = nn1(pts, verts)
            weights = _take_rows(smpl_weights.detach(), idx)[..., 0, :]
        else:
            d2, idx = knn(pts, verts, k=k)
            d2 = d2.clamp_max(DIST_CLAMP)
            conf = torch.exp(-d2)
            conf = conf / conf.sum(-1, keepdim=True)
            w = _take_rows(smpl_weights.detach(), idx)  # (..., N, k, J)
            weights = (w * conf[..., None]).sum(-2)
        outlier = torch.sqrt(d2[..., 0]) > OUTLIER_DIST
    return weights, outlier
