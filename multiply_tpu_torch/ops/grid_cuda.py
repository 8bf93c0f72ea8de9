"""Trilinear lookup in a baked SDF grid: Hopper kernel + plain version.

Counterpart of `multiply_tpu/ops/grid_pallas.py::_grid_trilinear`. The kernel
is `csrc/grid_trilinear.cu`. `grid_trilinear` dispatches by device only: a
CPU tensor goes to `grid_trilinear_plain`, a CUDA tensor to the kernel. Both
return a tensor without grad, matching the TPU kernel's zero tangent: the
only consumer thresholds the result.

With `group=1` the result has one value per point. With `group=S` it is the
least value of each run of S consecutive points (the samples of one ray), which
the kernel reduces in registers without writing the per-point values.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from .mesh_ops import grid_query


def _check_group(points: torch.Tensor, group: int) -> None:
    if not isinstance(group, int) or group < 1 or points.shape[-2] % group:
        raise ValueError(
            f"grid_trilinear: group {group!r} must be a positive int dividing N = {points.shape[-2]}"
        )


def grid_trilinear_plain(grid, points, origin, spacing, group: int = 1) -> torch.Tensor:
    """grid (..., r, r, r), points (..., N, 3), origin/spacing (..., 3) -> (..., N),
    or (..., N / group): the minimum over each run of `group` consecutive points."""
    _check_group(points, group)
    with torch.no_grad():
        if grid.dim() == 3:
            d = grid_query({"grid": grid, "origin": origin, "spacing": spacing}, points)
        else:
            d = torch.stack(
                [
                    grid_query({"grid": g, "origin": o, "spacing": s}, p)
                    for g, p, o, s in zip(grid, points, origin, spacing)
                ]
            )
        if group == 1:
            return d
        return d.reshape(d.shape[:-1] + (d.shape[-1] // group, group)).min(-1).values


_VP, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP)


def grid_trilinear_kernel(grid, points, origin, spacing, group: int = 1) -> torch.Tensor:
    """Launch `csrc/grid_trilinear.cu` on contiguous float32 CUDA tensors,
    unbatched or with a leading person axis on every argument: one kernel and
    nothing else."""
    for t in (grid, points, origin, spacing):
        if not t.is_cuda or t.device != points.device:
            raise ValueError("grid_trilinear kernel needs all tensors on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError("grid_trilinear kernel takes float32 tensors")
        if not t.is_contiguous():
            raise ValueError("grid_trilinear kernel needs contiguous tensors")
    batched = grid.dim() == 4
    res = grid.shape[-1]
    if (
        grid.dim() not in (3, 4)
        or grid.shape[-3:] != (res, res, res)
        or points.shape[-1] != 3
        or points.dim() != grid.dim() - 1
        or origin.shape != grid.shape[:-3] + (3,)
        or spacing.shape != origin.shape
        or (batched and points.shape[0] != grid.shape[0])
    ):
        raise ValueError("grid_trilinear kernel: bad shapes")
    _check_group(points, group)
    P = grid.shape[0] if batched else 1
    N = points.shape[-2]
    out = points.new_empty(points.shape[:-2] + (N // group,))
    if N > 0:
        launch = cuda_build.launcher("grid_trilinear", "grid_trilinear_launch", _ARGTYPES)
        err = launch(
            grid.data_ptr(), points.data_ptr(), origin.data_ptr(), spacing.data_ptr(),
            out.data_ptr(), P, N, res, group, cuda_build.current_stream(points.device),
        )
        cuda_build.check(err, "grid_trilinear")
        grid_trilinear.launches += 1
    return out


def grid_trilinear(grid, points, origin, spacing, group: int = 1) -> torch.Tensor:
    if points.is_cuda or grid.is_cuda:
        return grid_trilinear_kernel(grid, points, origin, spacing, group)
    return grid_trilinear_plain(grid, points, origin, spacing, group)


grid_trilinear.launches = 0
