"""Pretrain the canonical SDF network to the SMPL body shape.

Counterpart of `multiply_tpu/engine/smpl_init.py`: fit an `ImplicitNet`
(zero pose conditioning) to the exact signed distance of the canonical SMPL
mesh, on near-surface, perturbed and uniform box samples, with an L1 SDF term
plus eikonal regularisation, and cache the weights on disk, one file per
gender. The samples are the same numpy draws as the JAX package's; the
eikonal perturbation comes from a `torch.Generator`; the optimizer is Adam
(b1 0.9, b2 0.999, eps 1e-8 outside the square root) as optax's `adam(lr)`.

The cache holds the weights in the JAX package's layout ("params/lin0/kernel",
kernels (in, out)), so either package reads the other's file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..body.server import SMPLServer
from ..convert import flax_path, to_flax_layout
from ..models.networks import ImplicitNet
from ..ops.mesh_ops import signed_distance
from .optim import adam_init, adam_update

COND_WIDTH = {"smpl": 69, "frame": 32, "smpl_id": 133, "none": 0}


def sample_training_points(server: SMPLServer, n: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(points, gt_sdf): 40% near-surface, 40% medium noise, 20% uniform box."""
    verts = server.verts_c.detach().cpu().numpy()
    lo, hi = verts.min(0) - 0.5, verts.max(0) + 0.5

    n_near, n_med = int(n * 0.4), int(n * 0.4)
    idx = rng.integers(0, len(verts), n_near + n_med)
    pts = verts[idx].copy()
    pts[:n_near] += rng.normal(0, 0.01, (n_near, 3))
    pts[n_near:] += rng.normal(0, 0.1, (n_med, 3))
    uni = rng.uniform(lo, hi, (n - n_near - n_med, 3))
    pts = np.concatenate([pts, uni]).astype(np.float32)
    with torch.no_grad():
        gt = signed_distance(torch.as_tensor(pts, device=server.verts_c.device), server.verts_c, server.model.faces)
    return pts, gt.cpu().numpy()


def draw_perturbation(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The eikonal points' offsets of one step: 0.01 x a standard normal draw."""
    return torch.randn(shape, generator=generator, device=device) * 0.01


def smpl_init_loss(net: ImplicitNet, pts: torch.Tensor, gt: torch.Tensor, perturb: torch.Tensor,
                   eikonal_weight: float = 0.1):
    """(loss, l1, eikonal) of one batch; `perturb` is the eikonal points'
    offset from `pts` (0.01 x a standard normal draw)."""
    width = COND_WIDTH[net.cond]
    cond = torch.zeros((width,), device=pts.device) if width else None
    pred = net(pts, cond)[:, 0]
    l1 = (pred - gt).abs().mean()
    x = (pts + perturb).detach().requires_grad_(True)
    sdf = net(x, cond)[:, 0]
    (g,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    eik = ((g.norm(dim=-1) - 1.0) ** 2).mean()
    return l1 + eikonal_weight * eik, l1, eik


def pretrain_smpl_init(net: ImplicitNet, server: SMPLServer, steps: int = 2000, batch: int = 4096,
                       lr: float = 1e-4, eikonal_weight: float = 0.1, seed: int = 0, pool: int = 200_000,
                       verbose: bool = False, generator: torch.Generator | None = None) -> dict:
    """Train `net` (unstacked, in place) and return its parameters by name."""
    dev = server.verts_c.device
    rng = np.random.default_rng(seed)
    pts_pool, sdf_pool = sample_training_points(server, pool, rng)
    pts_pool, sdf_pool = torch.as_tensor(pts_pool, device=dev), torch.as_tensor(sdf_pool, device=dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(seed + 1)
    params = dict(net.named_parameters())
    state = adam_init(params)
    ones = {k: 1.0 for k in params}
    active = {k: True for k in params}
    for it in range(steps):
        sel = torch.as_tensor(rng.integers(0, pool, batch), device=dev)
        pts = pts_pool[sel]
        perturb = draw_perturbation(pts.shape, generator, dev)
        loss, l1, _ = smpl_init_loss(net, pts, sdf_pool[sel], perturb, eikonal_weight)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        state = adam_update(grads, state, params, lr, ones, active)
        if verbose and it % 200 == 0:
            print(f"smpl_init step {it}: loss={float(loss):.4f} l1={float(l1):.4f}")
    return {k: p.detach().clone() for k, p in params.items()}


def _cache_key(name: str) -> str:
    return "/".join(flax_path(f"net.fg_implicit.{name}")[0][2:])


def save_init(path: str, params: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {_cache_key(k): to_flax_layout(f"net.fg_implicit.{k}", v) for k, v in params.items()}
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_init(path: str, net: ImplicitNet) -> dict:
    """The cached weights, by `net`'s parameter names, on `net`'s device."""
    with np.load(path) as data:
        out = {}
        for name, p in net.named_parameters():
            value = data[_cache_key(name)]
            if flax_path(f"net.fg_implicit.{name}")[1]:
                value = np.swapaxes(value, -1, -2)
            out[name] = torch.tensor(value, dtype=p.dtype, device=p.device)
    return out


def get_or_pretrain(net: ImplicitNet, server: SMPLServer, cache_path: str, **kwargs) -> dict:
    if os.path.exists(cache_path):
        return load_init(cache_path, net)
    params = pretrain_smpl_init(net, server, **kwargs)
    save_init(cache_path, params)
    return params
