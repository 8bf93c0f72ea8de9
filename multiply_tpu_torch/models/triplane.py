"""Tri-plane feature fields for per-person identity conditioning (`cond: smpl_tri`).

Counterpart of `multiply_tpu/models/triplane.py`: `TriPlane` (xy/xz/yz feature
planes, bilinear-sampled and averaged) and `TriPlaneMulti` (a pyramid of
resolutions plus an adapter MLP that emits a feature and a delta-SDF).
Sampling goes through `ops/grid_sample.py`, which autograd differentiates to
any order. Built with `stack=P`, a module holds P persons' planes and maps
(P, N, 3) points.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.grid_sample import grid_sample_2d
from .networks import WNDense, _lecun_normal, softplus100


def _plane_features(planes: torch.Tensor, pts: torch.Tensor) -> list[torch.Tensor]:
    """planes (..., 3, C, R, R) as xy/xz/yz; pts (..., N, 3) in [-1, 1]
    -> the three per-plane features, each (..., N, C). The axes are taken by
    slices: indexing by a list makes a tensor on the host, which a CUDA graph
    capture refuses."""
    return [
        grid_sample_2d(planes[..., i, :, :, :], pts[..., axes])
        for i, axes in enumerate((slice(0, 2), slice(0, 3, 2), slice(1, 3)))
    ]


def sample_triplane(planes: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Mean of the three planes' features: (..., N, C)."""
    xy, xz, yz = _plane_features(planes, pts)
    return (xy + xz + yz) / 3.0


def _planes(st, features, res, generator, device):
    return nn.Parameter(torch.randn(st + (3, features, res, res), generator=generator, device=device) * 0.1)


class TriPlane(nn.Module):
    """Single-resolution tri-plane."""

    def __init__(self, features: int = 64, resolution: int = 128, stack: int | None = None,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.planes = _planes((stack,) if stack else (), features, resolution, generator, device)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return sample_triplane(self.planes, pts)


class TriPlaneMulti(nn.Module):
    """Multi-resolution pyramid + adapter MLP -> (feature (..., N, F),
    delta_sdf (..., N)). The per-plane features of all levels are concatenated;
    two softplus(beta=100) layers and a last layer that starts at +-1e-5 (zero
    bias) keep both outputs near 0 at the start, so the geometric SDF init
    survives switching the pyramid on."""

    def __init__(self, features: int = 64, resolutions: Sequence[int] = (128, 64, 32, 16),
                 adapter_width: int = 256, stack: int | None = None,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.resolutions = tuple(resolutions)
        st = (stack,) if stack else ()
        for r in self.resolutions:
            self.register_parameter(f"planes_{r}", _planes(st, features, r, generator, device))
        dims = [3 * features * len(self.resolutions), adapter_width, adapter_width]
        dense = [
            WNDense(_lecun_normal(st + (o, i), generator, device), torch.zeros(st + (o,), device=device), False)
            for i, o in zip(dims[:-1], dims[1:])
        ]
        last = (torch.rand(st + (features + 1, adapter_width), generator=generator, device=device) * 2 - 1) * 1e-5
        dense.append(WNDense(last, torch.zeros(st + (features + 1,), device=device), False))
        self.dense = nn.ModuleList(dense)

    def forward(self, pts: torch.Tensor):
        feats = []
        for r in self.resolutions:
            feats.extend(_plane_features(getattr(self, f"planes_{r}"), pts))
        h = torch.cat(feats, dim=-1)
        h = softplus100(self.dense[0](h))
        h = softplus100(self.dense[1](h))
        h = self.dense[2](h)
        return h[..., :-1], h[..., -1]
