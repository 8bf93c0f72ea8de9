"""The plain form of the nearest-neighbour kernel: direct differences, the
lowest index winning ties.

The card's kernel (`csrc/nn1.cu`) rounds each distance as
fma(dz, dz, fma(dy, dy, dx * dx)) from exactly rounded differences, where the
port's CPU path rounds (dx*dx + dy*dy) + dz*dz. The two part in the last bit,
and so pick another vertex where two lie that close to a query: a discrete
choice that parts a whole ray from the reference. So the reference rounds as
the path it is held against does: on a CUDA tensor with the fused
multiply-adds (`fma_f32`, each rounded once), on the CPU as the plain sum. The
nearest vertex is the same either way, up to that rounding.
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors, rounded once to float32 (to nearest,
    ties to even), as a fused multiply-add rounds it. The product is exact in
    float64; the float64 sum's own rounding error is recovered (TwoSum) and
    settles the one case where rounding twice goes wrong: a float64 sum that
    lands on the midpoint of two float32 values when the exact sum does not."""
    p, c64 = a.double() * b.double(), c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    f = s.float()
    inf = torch.full_like(f, float("inf"))
    g = torch.nextafter(f, torch.where(f.double() < s, inf, -inf))  # f's neighbour on s's side
    mid = (f.double() + g.double()) * 0.5 == s
    up, down = torch.maximum(f, g), torch.minimum(f, g)
    return torch.where(mid & (err != 0), torch.where(err > 0, up, down), f)


def nn1(query: torch.Tensor, refs: torch.Tensor, chunk_size: int = 8192):
    """(..., N, 3) vs (..., V, 3) -> d2 (..., N, 1) >= 0 and idx (..., N, 1) int64."""
    fused = query.is_cuda
    if fused:
        chunk_size = min(chunk_size, 2048)  # float64 temporaries
    d2s, idxs = [], []
    for q in query.split(chunk_size, dim=-2):
        diff = q[..., :, None, :] - refs[..., None, :, :]  # (..., C, V, 3)
        if fused:
            dx, dy, dz = diff.unbind(-1)
            d2 = fma_f32(dz, dz, fma_f32(dy, dy, dx * dx))
        else:
            sq = diff * diff
            d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        best, idx = d2.min(dim=-1, keepdim=True)
        d2s.append(best)
        idxs.append(idx)
    return torch.cat(d2s, dim=-2).clamp_min(0.0), torch.cat(idxs, dim=-2)
