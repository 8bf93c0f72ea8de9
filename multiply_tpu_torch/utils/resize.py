"""Bilinear resize that gives OpenCV's answers without OpenCV.

`resize_linear(img, (W, H))` is `cv2.resize(img, (W, H))` with the default
INTER_LINEAR, for uint8 and float32 images of shape (H, W) or (H, W, C), as
numpy arrays or torch tensors on any device. The rule, found by holding it
against OpenCV 5.0 (`tests/test_torch_sam_resize.py`):

  * each output index d samples the source at f = (d + 0.5) * s - 0.5, with
    s = 1 / (dst / src) in double precision;
  * columns: i = floor(f) and a = f - i; left of the first column i = 0 and
    a = 0, at or right of the last one i = src - 1 and a = 0;
  * rows: the same i and a, but a is never clamped: the two rows read are
    clip(i) and clip(i + 1), so a border row mixes a row with itself;
  * uint8 (fixed point, 11 fractional bits): f is rounded to float32 first
    and a taken in float32; the weights are round-half-even(a * 2048) and
    2048 minus that; a row pass sums in integers, and the column pass is
    OpenCV's vector form, (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16)
    + 2) >> 2, saturated to [0, 255]. Its truncations make a border row of a
    0/1 image come out 0 where rounding would give 1;
  * float32: a is taken in double precision and rounded to float32; weights
    (1 - a, a); rows first, then columns, in float32 (within 1e-7 relative of
    OpenCV, whose order of operations differs, for sources at least two
    pixels wide; a one-pixel-wide float source differs by up to 2e-5).
"""

from __future__ import annotations

import numpy as np
import torch

_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _axis(src: int, dst: int, clamp: bool, fixed: bool, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(first index, second index, weight of the second) of one axis."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    if fixed:
        f32 = f.astype(np.float32)
        i = np.floor(f32).astype(np.int64)
        a = f32 - i.astype(np.float32)
    else:
        i = np.floor(f).astype(np.int64)
        a = (f - i).astype(np.float32)
    if clamp:
        low, high = i < 0, i >= src - 1
        a = np.where(low | high, np.float32(0), a)
        i = np.where(low, 0, np.where(high, src - 1, i))
    i0, i1 = np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1)
    return (torch.as_tensor(i0, device=device), torch.as_tensor(i1, device=device),
            torch.as_tensor(a.astype(np.float32), device=device))


def resize_linear(img, dsize: tuple[int, int]):
    """`cv2.resize(img, dsize)` (INTER_LINEAR); dsize is (width, height)."""
    if isinstance(img, np.ndarray):
        return resize_linear(torch.from_numpy(np.ascontiguousarray(img)), dsize).numpy()
    W, H = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    fixed = img.dtype == torch.uint8
    if not fixed and img.dtype != torch.float32:
        raise TypeError(f"resize_linear takes uint8 or float32, not {img.dtype}")
    x0, x1, ax = _axis(w, W, True, fixed, img.device)
    y0, y1, ay = _axis(h, H, False, fixed, img.device)
    tail = (1,) * (img.dim() - 2)
    ax, ay = ax.reshape(1, W, *tail), ay.reshape(H, 1, *tail)
    if fixed:
        one = 1 << _BITS
        bx = torch.round(ax * one).to(torch.int32)
        by = torch.round(ay * one).to(torch.int32)
        x = img.to(torch.int32)
        rows = x[:, x0] * (one - bx) + x[:, x1] * bx
        s0, s1 = rows[y0] >> 4, rows[y1] >> 4
        out = ((((one - by) * s0) >> 16) + ((by * s1) >> 16) + 2) >> 2
        return out.clamp_(0, 255).to(torch.uint8)
    rows = img[:, x0] * (1 - ax) + img[:, x1] * ax
    return rows[y0] * (1 - ay) + rows[y1] * ay
