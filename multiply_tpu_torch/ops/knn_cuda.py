"""Nearest neighbour (K=1) against a small point set: Hopper kernel + plain version.

Counterpart of `multiply_tpu/ops/knn_pallas.py::nn1_pallas`. The kernel is
`csrc/nn1.cu` (its header says what bounds it and how it is laid out).
`nn1` dispatches by device only: a CPU tensor goes to `nn1_plain`, a CUDA
tensor to the kernel, which raises on what it does not take. The kernel rounds
the distance with fused multiply-adds, so on the card `d2` agrees with the
plain version to 1e-6 relative, and an index can differ only where two
references tie that closely.

`nn1_holes(hole)` stands `hole` in for the CUDA launch of this thread's `nn1`
calls while it is open.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from .. import cuda_build


def nn1_plain(query: torch.Tensor, refs: torch.Tensor, chunk_size: int = 8192):
    """Direct-difference NN: (..., N, 3) vs (..., V, 3) -> d2 (..., N, 1) >= 0
    and idx (..., N, 1) int64, the lowest index winning ties."""
    d2s, idxs = [], []
    for q in query.split(chunk_size, dim=-2):
        diff = q[..., :, None, :] - refs[..., None, :, :]  # (..., C, V, 3)
        sq = diff * diff
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        best, idx = d2.min(dim=-1, keepdim=True)  # first minimum on ties
        d2s.append(best)
        idxs.append(idx)
    return torch.cat(d2s, dim=-2).clamp_min(0.0), torch.cat(idxs, dim=-2)


_VP = ctypes.c_void_p
_ARGTYPES = (_VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP)


def nn1_kernel(query: torch.Tensor, refs: torch.Tensor, exact: bool = False):
    """Launch `csrc/nn1.cu` on (N, 3)/(V, 3) or (P, N, 3)/(P, V, 3) CUDA tensors:
    one kernel and nothing else. `exact` takes the build that rounds the
    distance as `nn1_plain` does (bit-identical to it, and slower): for checks."""
    if not (query.is_cuda and refs.is_cuda and query.device == refs.device):
        raise ValueError("nn1 kernel needs both tensors on the same CUDA device")
    if query.dtype != torch.float32 or refs.dtype != torch.float32:
        raise TypeError("nn1 kernel takes float32 points")
    if query.shape[-1] != 3 or refs.shape[-1] != 3 or query.dim() != refs.dim():
        raise ValueError(f"nn1 kernel shapes {tuple(query.shape)} vs {tuple(refs.shape)}")
    if query.dim() not in (2, 3) or (query.dim() == 3 and query.shape[0] != refs.shape[0]):
        raise ValueError(f"nn1 kernel shapes {tuple(query.shape)} vs {tuple(refs.shape)}")
    if not (query.is_contiguous() and refs.is_contiguous()):
        raise ValueError("nn1 kernel needs contiguous tensors")
    V, N = refs.shape[-2], query.shape[-2]
    if V == 0:
        raise ValueError("nn1 kernel needs at least one reference point")
    P = query.shape[0] if query.dim() == 3 else 1
    shape = query.shape[:-1] + (1,)
    d2 = query.new_empty(shape)
    idx = torch.empty(shape, dtype=torch.int64, device=query.device)
    if N > 0:
        launch = cuda_build.launcher("nn1_exact" if exact else "nn1", "nn1_launch", _ARGTYPES)
        err = launch(
            query.data_ptr(), refs.data_ptr(), d2.data_ptr(), idx.data_ptr(),
            P, N, V, cuda_build.current_stream(query.device),
        )
        cuda_build.check(err, "nn1")
        nn1.launches += 1
    return d2, idx


def nn1(query: torch.Tensor, refs: torch.Tensor):
    """Nearest neighbour: d2 (..., N, 1) and idx (..., N, 1). No autodiff."""
    if query.is_cuda or refs.is_cuda:
        hole = _holes.fn
        return nn1_kernel(query, refs) if hole is None else hole(query, refs)
    return nn1_plain(query, refs)


nn1.launches = 0


class _Holes(threading.local):
    fn = None


_holes = _Holes()


@contextlib.contextmanager
def nn1_holes(hole):
    """While open, this thread's `nn1` calls on CUDA tensors return
    `hole(query, refs)` and launch nothing."""
    _holes.fn = hole
    try:
        yield
    finally:
        _holes.fn = None
