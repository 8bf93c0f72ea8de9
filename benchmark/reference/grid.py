"""The plain form of the trilinear grid lookup: per-point values from
`mesh_ops.grid_query`, or the least value of each run of `group` points."""

from __future__ import annotations

import torch

from .mesh_ops import grid_query


def grid_trilinear(grid, points, origin, spacing, group: int = 1) -> torch.Tensor:
    """grid (..., r, r, r), points (..., N, 3), origin/spacing (..., 3) -> (..., N // group), no grad."""
    if group < 1 or points.shape[-2] % group:
        raise ValueError(f"group {group} must divide N = {points.shape[-2]}")
    with torch.no_grad():
        if grid.dim() == 3:
            d = grid_query({"grid": grid, "origin": origin, "spacing": spacing}, points)
        else:
            d = torch.stack([
                grid_query({"grid": g, "origin": o, "spacing": s}, p)
                for g, p, o, s in zip(grid, points, origin, spacing)
            ])
        if group == 1:
            return d
        return d.reshape(d.shape[:-1] + (d.shape[-1] // group, group)).min(-1).values
