"""Pretrain the canonical SDF network to the SMPL body shape (`smpl_init`).

A frozen copy of the port's `engine/smpl_init.py`: fit an `ImplicitNet`
(zero pose conditioning) to the exact signed distance of the canonical SMPL
mesh, on near-surface, perturbed and uniform box samples, with an L1 SDF term
plus eikonal regularisation, under Adam (b1 0.9, b2 0.999, eps 1e-8). The
network starts from `torch.Generator(device).manual_seed(0)`, as the port's
trainer starts it. The weights are cached by name in a `.npz` file of the
reference's own.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh_ops import signed_distance
from .networks import COND_DIMS, ImplicitNet
from .optim import adam_init, adam_update
from .server import SMPLServer


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


def smpl_init_loss(net: ImplicitNet, pts: torch.Tensor, gt: torch.Tensor, perturb: torch.Tensor,
                   eikonal_weight: float = 0.1):
    """(loss, l1, eikonal) of one batch; `perturb` is the eikonal points'
    offset from `pts` (0.01 x a standard normal draw)."""
    width = COND_DIMS[net.cond]  # the zero conditioning, as wide as the net takes it
    cond = torch.zeros((width,), device=pts.device) if width else None
    pred = net(pts, cond)[:, 0]
    l1 = (pred - gt).abs().mean()
    x = (pts + perturb).detach().requires_grad_(True)
    sdf = net(x, cond)[:, 0]
    (g,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    eik = ((g.norm(dim=-1) - 1.0) ** 2).mean()
    return l1 + eikonal_weight * eik, l1, eik


def pretrain(net: ImplicitNet, server: SMPLServer, steps: int = 2000, batch: int = 4096, lr: float = 1e-4,
             eikonal_weight: float = 0.1, seed: int = 0, pool: int = 200_000) -> dict:
    """Train `net` (unstacked, in place) and return its parameters by name."""
    dev = server.verts_c.device
    rng = np.random.default_rng(seed)
    pts_pool, sdf_pool = sample_training_points(server, pool, rng)
    pts_pool, sdf_pool = torch.as_tensor(pts_pool, device=dev), torch.as_tensor(sdf_pool, device=dev)
    generator = torch.Generator(dev).manual_seed(seed + 1)
    params = dict(net.named_parameters())
    state = adam_init(params)
    ones = {k: 1.0 for k in params}
    active = {k: True for k in params}
    for _ in range(steps):
        sel = torch.as_tensor(rng.integers(0, pool, batch), device=dev)
        pts = pts_pool[sel]
        perturb = torch.randn(pts.shape, generator=generator, device=dev) * 0.01
        loss, _, _ = smpl_init_loss(net, pts, sdf_pool[sel], perturb, eikonal_weight)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        state = adam_update(grads, state, params, lr, ones, active)
    return {k: p.detach().clone() for k, p in params.items()}


def get_or_pretrain(implicit_conf, server: SMPLServer, cache_path: str, steps: int, device) -> dict:
    """The pretrained weights by parameter name, from `cache_path` once it exists."""
    if os.path.exists(cache_path):
        with np.load(cache_path) as data:
            return {k: torch.as_tensor(data[k], device=device) for k in data.files}
    net = ImplicitNet.from_config(implicit_conf, device=device, generator=torch.Generator(device).manual_seed(0))
    params = pretrain(net, server, steps=steps)
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    tmp = f"{cache_path}.tmp{os.getpid()}.npz"
    np.savez(tmp, **{k: v.cpu().numpy() for k, v in params.items()})
    os.replace(tmp, cache_path)
    return params
