"""The plain form of the nearest-neighbour kernel: direct differences, the
lowest index winning ties."""

from __future__ import annotations

import torch


def nn1(query: torch.Tensor, refs: torch.Tensor, chunk_size: int = 8192):
    """(..., N, 3) vs (..., V, 3) -> d2 (..., N, 1) >= 0 and idx (..., N, 1) int64."""
    d2s, idxs = [], []
    for q in query.split(chunk_size, dim=-2):
        diff = q[..., :, None, :] - refs[..., None, :, :]  # (..., C, V, 3)
        sq = diff * diff
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        best, idx = d2.min(dim=-1, keepdim=True)
        d2s.append(best)
        idxs.append(idx)
    return torch.cat(d2s, dim=-2).clamp_min(0.0), torch.cat(idxs, dim=-2)
