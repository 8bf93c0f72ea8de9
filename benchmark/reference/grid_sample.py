"""Bilinear/trilinear grid sampling with exact higher-order derivatives.

Counterpart of `multiply_tpu/ops/grid_sample.py`: explicit corner gathers and
lerps, so autograd differentiates to any order with respect to the image and
the coordinates (the eikonal term differentiates through a tri-plane lookup
twice). Conventions are those of `torch.nn.functional.grid_sample` with
`align_corners=True, padding_mode='border'` for coords in [-1, 1]; that
function itself is not used, because its double backward with respect to the
coordinates is not implemented.

Both functions take any leading batch axes shared by image and coords.
"""

from __future__ import annotations

import torch


def _cell(coord: torch.Tensor, size: int):
    """[-1, 1] -> (index of the lower corner (long), fraction) along an axis of
    `size` texels. The index carries no gradient; the fraction does."""
    x = ((coord + 1.0) * (size - 1) / 2.0).clamp(0.0, size - 1.0)
    x0 = x.detach().floor().clamp(0, size - 2)
    return x0.long(), x - x0


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (..., C, T), idx (..., N) -> (..., C, N)."""
    idx = idx[..., None, :].expand(idx.shape[:-1] + (flat.shape[-2], idx.shape[-1]))
    return torch.gather(flat, -1, idx)


def grid_sample_2d(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """image (..., C, H, W); coords (..., N, 2) as (x, y) in [-1, 1] -> (..., N, C)."""
    H, W = image.shape[-2:]
    x0, fx = _cell(coords[..., 0], W)
    y0, fy = _cell(coords[..., 1], H)
    flat = image.flatten(-2)
    base = y0 * W + x0
    fx, fy = fx[..., None, :], fy[..., None, :]
    out = (
        _gather(flat, base) * (1 - fy) * (1 - fx)
        + _gather(flat, base + 1) * (1 - fy) * fx
        + _gather(flat, base + W) * fy * (1 - fx)
        + _gather(flat, base + W + 1) * fy * fx
    )
    return out.transpose(-1, -2)


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """volume (..., C, D, H, W); coords (..., N, 3) as (x, y, z) in [-1, 1]
    -> (..., N, C); x indexes W, y indexes H, z indexes D."""
    D, H, W = volume.shape[-3:]
    x0, fx = _cell(coords[..., 0], W)
    y0, fy = _cell(coords[..., 1], H)
    z0, fz = _cell(coords[..., 2], D)
    flat = volume.flatten(-3)
    base = (z0 * H + y0) * W + x0
    fx, fy, fz = fx[..., None, :], fy[..., None, :], fz[..., None, :]
    out = 0.0
    for dz, wz in ((0, 1 - fz), (1, fz)):
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                out = out + _gather(flat, base + (dz * H + dy) * W + dx) * wz * wy * wx
    return out.transpose(-1, -2)
