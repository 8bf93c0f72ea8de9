"""VolSDF error-bounded ray sampling with a fixed number of rounds.

Counterpart of `multiply_tpu/models/ray_sampler.py`: a (..., R, N_eval *
max_iters) z/sdf buffer; each round sorts the filled part, bisects beta
against the opacity error bound and upsamples N_eval fresh depths from the
error CDF; the last round draws the render samples from the weights. All
functions work on the last axis and take any leading axes, so the persons of
a scene are sampled together (leading axis P).

Noise is explicit: `error_bound_sample` takes `noise = {"u": (P, R,
N_samples) uniforms, "perm": (P, N_samples_extra) buffer indices}` in
training; with `noise=None` it is deterministic (eval mode).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .density import laplace_density
from .cameras import get_sphere_intersections


class SamplerConfig(NamedTuple):
    near: float = 0.0
    N_samples: int = 64
    N_samples_eval: int = 128
    N_samples_extra: int = 32
    eps: float = 0.1
    beta_iters: int = 10
    max_total_iters: int = 5
    N_samples_inverse_sphere: int = 32
    add_tiny: float = 1e-6
    scene_bounding_sphere: float = 3.0

    @staticmethod
    def from_config(opt, scene_bounding_sphere: float = 3.0) -> "SamplerConfig":
        return SamplerConfig(
            near=opt.near,
            N_samples=opt.N_samples,
            N_samples_eval=opt.N_samples_eval,
            N_samples_extra=opt.N_samples_extra,
            eps=opt.eps,
            beta_iters=opt.beta_iters,
            max_total_iters=opt.max_total_iters,
            N_samples_inverse_sphere=opt.get("N_samples_inverse_sphere", 32),
            add_tiny=opt.get("add_tiny", 1e-6),
            scene_bounding_sphere=scene_bounding_sphere,
        )


def uniform_z_vals(near, far, n: int, u: torch.Tensor | None = None) -> torch.Tensor:
    """Linspace between near (..., 1) and far (..., 1); stratified jitter with
    uniforms `u` of the output's shape when given."""
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    z = near * (1.0 - t) + far * t
    if u is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        z = lower + (upper - lower) * u
    return z


def _sample_cdf(bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling: bins, cdf (..., M) ascending with cdf[..., 0] == 0,
    u (..., N). The bracket of each u is [last entry with cdf <= u, the next],
    clamped to the last bin."""
    M = cdf.shape[-1]
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (above - 1).clamp_min(0)
    above = above.clamp_max(M - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bin_b, bin_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


def _dstar(z_vals: torch.Tensor, sdf: torch.Tensor):
    """VolSDF Theorem-1 lower bound on distance-to-surface per section:
    (dists (..., M-1), d_star (..., M-1))."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    a, b, c = dists, sdf[..., :-1].abs(), sdf[..., 1:].abs()
    first = a**2 + b**2 <= c**2
    second = a**2 + c**2 <= b**2
    s = (a + b + c) / 2.0
    area2 = (s * (s - a) * (s - b) * (s - c)).clamp_min(0.0)
    h = 2.0 * torch.sqrt(area2) / a.clamp_min(1e-12)
    zero = torch.zeros_like(h)
    d_star = torch.where(first, b, torch.where(second, c, torch.where(b + c - a > 0, h, zero)))
    same_sign = torch.sign(sdf[..., 1:]) * torch.sign(sdf[..., :-1]) == 1
    return dists, torch.where(same_sign, d_star, zero)


def _error_bound(beta, sdf, dists, d_star) -> torch.Tensor:
    """Max opacity error bound per ray; beta (..., 1)."""
    density = laplace_density(sdf, beta)
    shifted = torch.cat([torch.zeros_like(dists[..., :1]), dists * density[..., :-1]], dim=-1)
    integral = torch.cumsum(shifted, dim=-1)
    err = torch.exp(-d_star / beta) * dists**2 / (4.0 * beta**2)
    err_int = torch.cumsum(err, dim=-1)
    bound = (torch.exp(err_int).clamp_max(1e6) - 1.0) * torch.exp(-integral[..., :-1])
    return bound.max(dim=-1).values


def error_bound_sample(
    cfg: SamplerConfig,
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],  # (P, N, 3) -> (P, N)
    ray_o: torch.Tensor,  # (R, 3)
    ray_d: torch.Tensor,  # (R, 3)
    beta0: float | torch.Tensor,  # current Laplace beta (no grad)
    num_fields: int,  # P: independent SDF fields sampled along the same rays
    noise: dict | None = None,
    ray_range: tuple | None = None,  # per-ray (near (P, R), far (P, R))
) -> dict:
    """Returns z_vals (P, R, N_samples + N_samples_extra + 2), sorted, and beta_final (P, R).
    `ray_range` clips sampling to a per-ray interval (a person's bounding-box
    entry and exit) instead of [near, sphere exit]: the same budget of
    evaluations, concentrated on the subject."""
    P, R = num_fields, ray_o.shape[0]
    n_eval, iters = cfg.N_samples_eval, cfg.max_total_iters
    M = n_eval * iters
    dev = ray_o.device

    far = get_sphere_intersections(ray_o, ray_d, r=cfg.scene_bounding_sphere)[:, 1:]
    if ray_range is not None:
        near = ray_range[0][..., None]
        far = torch.minimum(ray_range[1][..., None], far)
        far = torch.maximum(far, near + 1e-4)
    else:
        far = far.expand(P, R, 1)
        near = torch.full((P, R, 1), float(cfg.near), device=dev)

    def eval_sdf(z):  # (P, R, n) -> (P, R, n)
        pts = ray_o[:, None, :] + z[..., None] * ray_d[:, None, :]
        return sdf_fn(pts.reshape(P, -1, 3)).reshape(z.shape)

    z0 = uniform_z_vals(near, far, n_eval)
    zbuf = torch.cat([z0, far.expand(P, R, M - n_eval)], dim=-1)
    sbuf = torch.cat([eval_sdf(z0), eval_sdf(far).expand(P, R, M - n_eval)], dim=-1)

    # Lemma-2 initial beta upper bound
    d0 = z0[..., 1:] - z0[..., :-1]
    beta = torch.sqrt((1.0 / (4.0 * math.log(cfg.eps + 1.0))) * (d0**2).sum(-1))  # (P, R)
    beta0 = torch.as_tensor(beta0, dtype=torch.float32, device=dev)

    for r in range(iters):
        m_act = n_eval * (r + 1)
        z_act, order = torch.sort(zbuf[..., :m_act], dim=-1, stable=True)
        s_act = sbuf[..., :m_act].gather(-1, order)
        dists, d_star = _dstar(z_act, s_act)

        # beta bisection between beta0 and the current per-ray beta
        err_at_b0 = _error_bound(beta0.expand(P, R, 1), s_act, dists, d_star)
        beta = torch.where(err_at_b0 <= cfg.eps, beta0, beta)
        b_min = beta0.expand(P, R)
        b_max = beta
        for _ in range(cfg.beta_iters):
            b_mid = 0.5 * (b_min + b_max)
            err = _error_bound(b_mid[..., None], s_act, dists, d_star)
            b_max = torch.where(err <= cfg.eps, b_mid, b_max)
            b_min = torch.where(err > cfg.eps, b_mid, b_min)
        beta = b_max

        density = laplace_density(s_act, beta[..., None])
        dists_inf = torch.cat([dists, torch.full((P, R, 1), 1e10, device=dev)], dim=-1)
        free_energy = dists_inf * density
        shifted = torch.cat([torch.zeros((P, R, 1), device=dev), free_energy[..., :-1]], dim=-1)
        alpha = 1.0 - torch.exp(-free_energy)
        transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
        weights = alpha * transmittance

        if r < iters - 1:
            # upsample by the error-bound CDF
            b = beta[..., None]
            err = torch.exp(-d_star / b) * dists_inf[..., :-1] ** 2 / (4.0 * b**2)
            err_int = torch.cumsum(err, dim=-1)
            bound_opacity = (torch.exp(err_int).clamp_max(1e6) - 1.0) * transmittance[..., :-1]
            pdf = bound_opacity + cfg.add_tiny
            pdf = pdf / pdf.sum(-1, keepdim=True)
            cdf = torch.cat([torch.zeros((P, R, 1), device=dev), torch.cumsum(pdf, dim=-1)], -1)
            u = torch.linspace(0.0, 1.0, n_eval, device=dev).expand(P, R, n_eval)
            z_new = _sample_cdf(z_act, cdf, u)
            zbuf = torch.cat([zbuf[..., :m_act], z_new, zbuf[..., m_act + n_eval:]], dim=-1)
            sbuf = torch.cat([sbuf[..., :m_act], eval_sdf(z_new), sbuf[..., m_act + n_eval:]], dim=-1)
        else:
            # final draw from the rendering weights
            pdf = weights[..., :-1] + 1e-5
            pdf = pdf / pdf.sum(-1, keepdim=True)
            cdf = torch.cat([torch.zeros((P, R, 1), device=dev), torch.cumsum(pdf, dim=-1)], -1)
            if noise is not None:
                u = noise["u"]
            else:
                u = torch.linspace(0.0, 1.0, cfg.N_samples, device=dev).expand(P, R, cfg.N_samples)
            z_final = _sample_cdf(z_act, cdf, u)
            z_sorted_full = z_act

    # extra samples: near, far (sphere) and N_extra picks from the buffer
    extra = [near, far]
    if cfg.N_samples_extra > 0:
        if noise is not None:
            perm = noise["perm"]
        else:
            perm = torch.linspace(0, M - 1, cfg.N_samples_extra, device=dev).long().expand(P, -1)
        extra.append(z_sorted_full.gather(-1, perm[:, None, :].expand(P, R, -1)))
    z_vals = torch.sort(torch.cat([z_final] + extra, dim=-1), dim=-1).values
    return {"z_vals": z_vals, "beta_final": beta}
