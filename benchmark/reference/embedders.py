"""NeRF positional (Fourier) encoding.

Counterpart of `multiply_tpu/ops/embedders.py`: include_input=True, frequencies
2^0..2^(multires-1), feature order [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...].
"""

from __future__ import annotations

import torch


def embedding_dim(multires: int, input_dims: int = 3) -> int:
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """(..., D) -> (..., D*(1+2*multires)). multires<=0 is identity."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)  # (L,)
    xb = x[..., None, :] * freqs[:, None]  # (..., L, D)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., L, 2, D)
    enc = enc.reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1)
