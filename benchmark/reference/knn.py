"""K-nearest-neighbour search against a small reference point set.

Counterpart of `multiply_tpu/ops/knn.py`: the |x|^2 + |v|^2 - 2 x.v expansion
in full f32, chunked over queries. The training path (K=1) goes through the
`nn1` kernel instead (`knn_cuda.py`); this serves K > 1.
"""

from __future__ import annotations

import torch


def knn(query: torch.Tensor, refs: torch.Tensor, k: int = 1, chunk_size: int = 8192):
    """(..., N, D) vs (..., V, D) -> (sq_dists (..., N, k) >= 0, indices (..., N, k)),
    nearest first."""
    refs_sq = (refs * refs).sum(-1)[..., None, :]  # (..., 1, V)
    d2s, idxs = [], []
    for q in query.split(chunk_size, dim=-2):
        q_sq = (q * q).sum(-1, keepdim=True)
        d2 = q_sq + refs_sq - 2.0 * (q @ refs.transpose(-1, -2))
        if k == 1:
            best, idx = d2.min(dim=-1, keepdim=True)
        else:
            neg, idx = torch.topk(-d2, k, dim=-1)
            best = -neg
        d2s.append(best.clamp_min(0.0))
        idxs.append(idx)
    return torch.cat(d2s, dim=-2), torch.cat(idxs, dim=-2)
