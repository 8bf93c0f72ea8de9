"""Trilinear lookup in a baked SDF grid: Hopper kernel + plain version.

Counterpart of `multiply_tpu/ops/grid_pallas.py::_grid_trilinear`. The kernel
is `csrc/grid_trilinear.cu`. `grid_trilinear` dispatches by device only: a
CPU tensor goes to `grid_trilinear_plain`, a CUDA tensor to the kernel. Both
return a tensor without grad, matching the TPU kernel's zero tangent: the
only consumer thresholds the result.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from .mesh_ops import grid_query


def grid_trilinear_plain(grid, points, origin, spacing) -> torch.Tensor:
    """grid (..., r, r, r), points (..., N, 3), origin/spacing (..., 3) -> (..., N)."""
    with torch.no_grad():
        if grid.dim() == 3:
            return grid_query({"grid": grid, "origin": origin, "spacing": spacing}, points)
        return torch.stack(
            [
                grid_query({"grid": g, "origin": o, "spacing": s}, p)
                for g, p, o, s in zip(grid, points, origin, spacing)
            ]
        )


def _lib():
    lib = cuda_build.load("grid_trilinear")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.grid_trilinear_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.grid_trilinear_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def grid_trilinear_kernel(grid, points, origin, spacing) -> torch.Tensor:
    """Launch `csrc/grid_trilinear.cu` on CUDA tensors: unbatched or with a
    leading person axis on every argument."""
    args = (grid, points, origin, spacing)
    if not all(t.is_cuda and t.device == points.device for t in args):
        raise ValueError("grid_trilinear kernel needs all tensors on one CUDA device")
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("grid_trilinear kernel takes float32 tensors")
    batched = grid.dim() == 4
    res = grid.shape[-1]
    if (
        grid.dim() not in (3, 4)
        or grid.shape[-3:] != (res, res, res)
        or points.shape[-1] != 3
        or points.dim() != grid.dim() - 1
        or origin.shape[-1] != 3
        or spacing.shape[-1] != 3
        or (batched and not (points.shape[0] == origin.shape[0] == spacing.shape[0] == grid.shape[0]))
    ):
        raise ValueError("grid_trilinear kernel: bad shapes")
    P = grid.shape[0] if batched else 1
    grid, points, origin, spacing = (t.detach().contiguous() for t in args)
    N = points.shape[-2]
    out = torch.empty(points.shape[:-1], dtype=torch.float32, device=points.device)
    if N > 0:
        err = _lib().grid_trilinear_launch(
            grid.data_ptr(), points.data_ptr(), origin.data_ptr(), spacing.data_ptr(),
            out.data_ptr(), P, N, res, torch.cuda.current_stream(points.device).cuda_stream,
        )
        cuda_build.check(err, "grid_trilinear")
        grid_trilinear.launches += 1
    return out


def grid_trilinear(grid, points, origin, spacing) -> torch.Tensor:
    if points.is_cuda or grid.is_cuda:
        return grid_trilinear_kernel(grid, points, origin, spacing)
    return grid_trilinear_plain(grid, points, origin, spacing)


grid_trilinear.launches = 0
