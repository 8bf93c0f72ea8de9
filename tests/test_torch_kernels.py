"""The port's two kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold the
plain versions against the Pallas kernels (interpret mode) and the JAX plain
functions. `test_torch_cuda.py` holds each CUDA kernel against its plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (thread count)
from multiply_tpu.ops.grid_pallas import _grid_trilinear
from multiply_tpu.ops.knn import knn as knn_jax
from multiply_tpu.ops.knn_pallas import nn1_pallas
from multiply_tpu.ops.mesh_ops import grid_query as grid_query_jax
from multiply_tpu_torch.ops import grid_cuda, knn_cuda
from multiply_tpu_torch.ops.knn import knn as knn_torch


def _points(seed, n, v):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((v, 3)).astype(np.float32))


@pytest.mark.parametrize("n,v", [(1500, 386), (700, 2049), (64, 5)])
def test_nn1_plain_matches_pallas_interpret(n, v):
    """V not a multiple of any tile (2048 on the TPU, 2048 in the CUDA kernel)."""
    q, r = _points(n + v, n, v)
    d2_p, idx_p = knn_cuda.nn1_plain(torch.tensor(q), torch.tensor(r))
    d2_j, idx_j = nn1_pallas(jnp.asarray(q), jnp.asarray(r), interpret=True)
    # the same direct differences in f32: indices equal, d2 to f32 rounding
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_p.numpy(), np.asarray(d2_j), atol=1e-6, rtol=1e-6)
    assert idx_p.dtype == torch.int64 and d2_p.shape == (n, 1)


def test_nn1_plain_matches_jnp_knn_up_to_ties():
    """JAX's CPU path uses the |q|^2+|v|^2-2q.v expansion: d2 agrees to its
    cancellation error; an index may differ only where two refs nearly tie."""
    q, r = _points(7, 3000, 386)
    d2_p, idx_p = knn_cuda.nn1_plain(torch.tensor(q), torch.tensor(r))
    d2_j, idx_j = knn_jax(jnp.asarray(q), jnp.asarray(r), k=1)
    np.testing.assert_allclose(d2_p.numpy(), np.asarray(d2_j), atol=2e-5)
    diff = idx_p.numpy()[:, 0] != np.asarray(idx_j)[:, 0]
    d_alt = ((q[diff] - r[np.asarray(idx_j)[diff, 0]]) ** 2).sum(-1)
    assert np.all(np.abs(d_alt - d2_p.numpy()[diff, 0]) <= 2e-5)


def test_nn1_batched_persons_and_ties():
    q, r = _points(3, 200, 50)
    r[10] = r[3]  # exact duplicate: the lower index wins
    qb = torch.tensor(np.stack([q, q[::-1].copy()]))
    rb = torch.tensor(np.stack([r, r[::-1].copy()]))
    d2, idx = knn_cuda.nn1(qb, rb)
    for p in range(2):
        d2_1, idx_1 = knn_cuda.nn1_plain(qb[p], rb[p])
        assert torch.equal(idx[p], idx_1) and torch.equal(d2[p], d2_1)
    assert not (idx[0] == 10).any()
    k_d2, k_idx = knn_torch(qb, rb, k=1)
    np.testing.assert_allclose(k_d2.numpy(), d2.numpy(), atol=2e-5)


def test_knn_topk_matches_jax():
    q, r = _points(11, 300, 120)
    d2_t, idx_t = knn_torch(torch.tensor(q), torch.tensor(r), k=4, chunk_size=128)
    d2_j, idx_j = knn_jax(jnp.asarray(q), jnp.asarray(r), k=4, chunk_size=128)
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=2e-5)
    assert (idx_t.numpy() == np.asarray(idx_j)).mean() > 0.99


def _grid_case(seed, res=16, n=700):
    rng = np.random.default_rng(seed)
    grid = rng.standard_normal((res, res, res)).astype(np.float32)
    origin = np.array([-0.6, -1.1, -0.4], np.float32)
    spacing = np.array([0.08, 0.11, 0.05], np.float32)
    hi = origin + spacing * (res - 1)
    # 20% beyond the grid on every side: the clamp to the border
    pts = (origin - 0.2 * (hi - origin) + rng.random((n, 3)) * 1.4 * (hi - origin)).astype(np.float32)
    return grid, pts, origin, spacing


def test_grid_trilinear_plain_matches_grid_query():
    grid, pts, origin, spacing = _grid_case(0)
    got = grid_cuda.grid_trilinear(*(torch.tensor(x) for x in (grid, pts, origin, spacing)))
    want = grid_query_jax({"grid": jnp.asarray(grid), "origin": jnp.asarray(origin),
                           "spacing": jnp.asarray(spacing)}, jnp.asarray(pts))
    # the same f32 formula in the same order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert not got.requires_grad


def test_grid_trilinear_plain_matches_pallas_interpret():
    grid, pts, origin, spacing = _grid_case(1, n=1100)
    got = grid_cuda.grid_trilinear_plain(*(torch.tensor(x) for x in (grid, pts, origin, spacing)))
    want = _grid_trilinear(jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(origin),
                           jnp.asarray(spacing), True)
    # the TPU kernel rounds the grid to bf16 (8 mantissa bits): |g| ~ 3 gives
    # up to ~2^-8 * 3 / 2 absolute error per corner
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_grid_trilinear_batched_and_grad_free():
    cases = [_grid_case(s) for s in (2, 3)]
    stacked = [torch.tensor(np.stack(x)) for x in zip(*cases)]
    pts = stacked[1].requires_grad_(True)
    out = grid_cuda.grid_trilinear(stacked[0], pts, stacked[2], stacked[3])
    assert out.shape == (2, 700) and not out.requires_grad
    for p in range(2):
        one = grid_cuda.grid_trilinear(*(torch.tensor(x) for x in cases[p]))
        assert torch.equal(out[p], one)


def test_grid_trilinear_fused_min_matches_jax_renderer_path():
    """group = S against what the JAX renderer does with the per-point values:
    `grid_query`, then `jnp.min` over each ray's S samples."""
    R, S = 50, 13
    grid, pts, origin, spacing = _grid_case(6, n=R * S)
    got = grid_cuda.grid_trilinear(*(torch.tensor(x) for x in (grid, pts, origin, spacing)), group=S)
    d = grid_query_jax({"grid": jnp.asarray(grid), "origin": jnp.asarray(origin),
                        "spacing": jnp.asarray(spacing)}, jnp.asarray(pts)).reshape(R, S)
    want = jnp.min(d, axis=-1)
    assert got.shape == (R,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # batched over persons: each person's rays reduced on their own
    stacked = [torch.tensor(np.stack([x, x])) for x in (grid, pts, origin, spacing)]
    both = grid_cuda.grid_trilinear(*stacked, group=S)
    assert both.shape == (2, R) and torch.equal(both[0], got) and torch.equal(both[1], got)
    # group 1 is the per-point form
    per_point = grid_cuda.grid_trilinear(*(torch.tensor(x) for x in (grid, pts, origin, spacing)), group=1)
    assert torch.equal(per_point.reshape(R, S).min(-1).values, got)


@pytest.mark.parametrize("group", [4, 0, -1, 2.0])
def test_grid_trilinear_refuses_a_group_that_does_not_divide(group):
    args = [torch.tensor(x) for x in _grid_case(7, n=26)]
    with pytest.raises(ValueError):
        grid_cuda.grid_trilinear(*args, group=group)
    with pytest.raises(ValueError):
        grid_cuda.grid_trilinear_plain(*args, group=group)


@pytest.mark.parametrize("n", [1024, 8, 776])
def test_nn1_plain_output_form_at_the_step_shapes(n):
    """Small stand-ins for the step's three calls (sampler round, eikonal
    points, render samples), both persons at once, V = 386."""
    rng = np.random.default_rng(n)
    q = torch.tensor(rng.standard_normal((2, n, 3)).astype(np.float32))
    r = torch.tensor(rng.standard_normal((2, 386, 3)).astype(np.float32))
    d2, idx = knn_cuda.nn1(q, r)
    assert d2.shape == idx.shape == (2, n, 1)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int64
    assert (d2 >= 0).all() and (idx >= 0).all() and (idx < 386).all()
    nearest = torch.take_along_dim(r, idx.expand(2, n, 3), dim=1)
    np.testing.assert_allclose(((q - nearest) ** 2).sum(-1, keepdim=True).numpy(), d2.numpy(), rtol=1e-5)


def test_cpu_dispatch_launches_no_kernel():
    q, r = _points(5, 10, 4)
    before = (knn_cuda.nn1.launches, grid_cuda.grid_trilinear.launches)
    knn_cuda.nn1(torch.tensor(q), torch.tensor(r))
    grid_cuda.grid_trilinear(*(torch.tensor(x) for x in _grid_case(4, n=8)))
    grid_cuda.grid_trilinear(*(torch.tensor(x) for x in _grid_case(4, n=8)), group=4)
    assert (knn_cuda.nn1.launches, grid_cuda.grid_trilinear.launches) == before
    with pytest.raises(ValueError):
        knn_cuda.nn1_kernel(torch.tensor(q), torch.tensor(r))  # CPU tensors never reach the kernel
