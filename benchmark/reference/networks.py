"""SDF and appearance MLPs as `nn.Module`s.

Counterpart of `multiply_tpu/models/networks.py`:
  * ImplicitNet: softplus(beta=100) MLP, skip connection, Fourier PE,
    pose/frame conditioning at layer 0, geometric init, weight norm; output
    [sdf, features].
  * OffsetHead: a per-person refinement head over a shared ImplicitNet;
    BetaEncoder: a per-person shape-code injection at layer 0.
  * RenderingNet: modes 'idr', 'nerf', 'nerf_frame_encoding' (background),
    'pose_no_view' (foreground default) and 'pose_id_no_view'.

A network built with `stack=P` holds P independent copies of its weights
(leading axis P) and maps (P, N, d) inputs with batched matmuls, so all
persons run in one launch per layer; a network built without `stack` maps
the same inputs with one shared set of weights. Weights are (out, in), as
torch keeps them. The weight norm is taken in the leaves' own type, so a
network called on bfloat16 leaves (`torch.func.functional_call`, as the
sampler does) normalises in bfloat16.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .embedders import embedding_dim, positional_encoding

COND_DIMS = {"smpl": 69, "frame": 32, "smpl_id": 69 + 64, "smpl_tri": 69 + 64, "none": 0}


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus with beta=100."""
    return F.softplus(100.0 * x) / 100.0


def _lecun_normal(shape, generator, device) -> torch.Tensor:
    """flax's default kernel init: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / shape[-1]) / 0.87962566103423978
    w = torch.empty(shape, device=device)
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def _normal(shape, std, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * std


def _uniform(shape, scale, generator, device) -> torch.Tensor:
    """flax's `uniform(scale)`: U[0, scale)."""
    return torch.rand(shape, generator=generator, device=device) * scale


class WNDense(nn.Module):
    """Dense layer with optional weight normalization per output over the
    input axis: w = g * v / ||v||, with g initialised to ||v|| so the initial
    effective weight equals the raw initialization."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, weight_norm: bool = True):
        super().__init__()
        self.weight = nn.Parameter(weight)  # (..., out, in)
        self.bias = nn.Parameter(bias)  # (..., out)
        self.g = nn.Parameter(weight.norm(dim=-1)) if weight_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b, g = self.weight, self.bias, self.g
        if g is not None:
            w = w * (g / w.norm(dim=-1).clamp_min(1e-12))[..., None]
        if w.dtype != x.dtype:  # a mixed product runs in the wider type
            wide = torch.promote_types(w.dtype, x.dtype)
            x, w, b = x.to(wide), w.to(wide), b.to(wide)
        return x @ w.transpose(-1, -2) + b[..., None, :]


def _geometric_init(layer, num_layers, in_dim, out_dim, d_in, input_dim_embedded,
                    skip_in, multires, bias_const, stack, generator, device):
    """SAL geometric init of one layer: (weight (..., out, in), bias (..., out))."""
    shape = stack + (out_dim, in_dim)
    if layer == num_layers - 2:
        w = math.sqrt(math.pi) / math.sqrt(in_dim) + _normal(shape, 1e-4, generator, device)
        return w, torch.full(stack + (out_dim,), -bias_const, device=device)
    w = _normal(shape, math.sqrt(2) / math.sqrt(out_dim), generator, device)
    if multires > 0 and layer == 0:
        w[..., d_in:] = 0.0  # PE and conditioning channels start silent
    elif multires > 0 and layer in skip_in:
        w[..., in_dim - (input_dim_embedded - d_in):] = 0.0  # PE part of the skip input
    return w, torch.zeros(stack + (out_dim,), device=device)


class ImplicitNet(nn.Module):
    """Canonical-space SDF + feature field: (..., N, d_in) -> (..., N, 1 + F)."""

    def __init__(
        self,
        d_in: int = 3,
        d_out: int = 1,
        dims: Sequence[int] = (256,) * 8,
        feature_vector_size: int = 256,
        skip_in: Sequence[int] = (4,),
        multires: int = 6,
        cond: str = "smpl",
        init_mode: str = "geometry",
        bias: float = 0.6,
        weight_norm: bool = True,
        cond_dim: int | None = None,  # width of the conditioning vector; default by `cond`
        stack: int | None = None,
        generator: torch.Generator | None = None,
        device="cuda",
    ):
        super().__init__()
        if cond not in COND_DIMS:
            raise NotImplementedError(f"ImplicitNet cond={cond!r}")
        self.multires, self.cond, self.skip_in = multires, cond, tuple(skip_in)
        in0 = embedding_dim(multires, d_in)
        all_dims = [in0] + list(dims) + [d_out + feature_vector_size]
        self.num_layers = len(all_dims)
        st = (stack,) if stack else ()
        lins = []
        h_dim = in0
        for l in range(self.num_layers - 1):
            out_dim = all_dims[l + 1] - (in0 if l + 1 in self.skip_in else 0)
            if l == 0:
                h_dim += COND_DIMS[cond] if cond_dim is None else cond_dim
            if l in self.skip_in:
                h_dim += in0
            if init_mode == "geometry":
                w, b = _geometric_init(l, self.num_layers, h_dim, out_dim, d_in, in0,
                                       self.skip_in, multires, bias, st, generator, device)
            else:
                w = _lecun_normal(st + (out_dim, h_dim), generator, device)
                b = torch.zeros(st + (out_dim,), device=device)
            lins.append(WNDense(w, b, weight_norm))
            h_dim = out_dim
        self.lins = nn.ModuleList(lins)

    @staticmethod
    def from_config(opt, cond_dim=None, stack=None, generator=None, device="cuda") -> "ImplicitNet":
        return ImplicitNet(
            d_in=opt.d_in, d_out=opt.d_out, dims=tuple(opt.dims),
            feature_vector_size=opt.feature_vector_size, skip_in=tuple(opt.skip_in),
            multires=opt.multires, cond=opt.cond, init_mode=opt.get("init", "geometry"),
            bias=opt.get("bias", 0.6), weight_norm=opt.get("weight_norm", True),
            cond_dim=cond_dim, stack=stack, generator=generator, device=device,
        )

    def forward(self, x: torch.Tensor, cond_vec: torch.Tensor | None = None,
                layer0_extra: torch.Tensor | None = None) -> torch.Tensor:
        """x (..., N, d_in); cond_vec (..., c) per leading entry or (..., N, c);
        layer0_extra (..., 1 or N, dims[0]) is added after layer 0 (the
        beta-encoding hook)."""
        inp = positional_encoding(x, self.multires)
        if self.cond != "none":
            if cond_vec.dim() == x.dim() - 1:
                cond_vec = cond_vec[..., None, :]
            cond_vec = cond_vec.expand(x.shape[:-1] + cond_vec.shape[-1:])
        h = inp
        for l, lin in enumerate(self.lins):
            if self.cond != "none" and l == 0:
                h = torch.cat([h, cond_vec], dim=-1)
            if l in self.skip_in:
                h = torch.cat([h, inp], dim=-1) / math.sqrt(2.0)
            h = lin(h)
            if l == 0 and layer0_extra is not None:
                h = h + layer0_extra
            if l < self.num_layers - 2:
                h = softplus100(h)
        return h


class OffsetHead(nn.Module):
    """Per-person refinement head over a shared ImplicitNet: takes [shared
    output, conditioning, embedded input] and emits a delta-SDF plus (unless
    `no_head_feature`) replacement features. Its last layer starts near zero,
    so the shared field dominates at the start."""

    def __init__(self, in_dim: int, feature_vector_size: int = 256, width: int = 256,
                 no_head_feature: bool = False, stack: int | None = None,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.no_head_feature = no_head_feature
        st = (stack,) if stack else ()
        heads, h_dim = [], in_dim
        for _ in range(4):
            w = _lecun_normal(st + (width, h_dim), generator, device)
            heads.append(WNDense(w, torch.zeros(st + (width,), device=device)))
            h_dim = width
        self.heads = nn.ModuleList(heads)
        w = _uniform(st + (feature_vector_size + 1, width), 1e-6, generator, device)
        self.last = WNDense(w, torch.zeros(st + (feature_vector_size + 1,), device=device))

    def forward(self, shared_out, cond, inp):
        """shared_out (..., N, 1 + F); cond (..., c) or (..., N, c); inp (..., N, e)."""
        if cond.dim() == shared_out.dim() - 1:
            cond = cond[..., None, :]
        cond = cond.expand(shared_out.shape[:-1] + cond.shape[-1:])
        h = torch.cat([shared_out, cond, inp], dim=-1)
        for lin in self.heads:
            h = softplus100(lin(h))
        h = self.last(h)
        sdf = shared_out[..., 0:1] + h[..., 0:1]
        feat = shared_out[..., 1:] if self.no_head_feature else h[..., 1:]
        return torch.cat([sdf, feat], dim=-1)


class BetaEncoder(nn.Module):
    """Per-person shape-code injection at layer 0: a near-zero-initialised
    Linear(10 -> width) whose output is added to the first layer's activations."""

    def __init__(self, width: int = 256, stack: int | None = None,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        st = (stack,) if stack else ()
        w = _uniform(st + (width, 10), 1e-5, generator, device)
        self.beta_layer = WNDense(w, torch.zeros(st + (width,), device=device))

    def forward(self, betas: torch.Tensor) -> torch.Tensor:
        """betas (..., 10) -> (..., 1, width), to broadcast over the points."""
        return self.beta_layer(betas[..., None, :])


class RenderingNet(nn.Module):
    """Appearance MLP; `mode` chooses what it is conditioned on."""

    def __init__(
        self,
        mode: str = "pose_no_view",
        d_out: int = 3,
        dims: Sequence[int] = (256,) * 4,
        feature_vector_size: int = 256,
        multires_view: int = -1,
        weight_norm: bool = True,
        dim_frame_encoding: int = 32,
        dim_cond_embed: int = 8,
        stack: int | None = None,
        generator: torch.Generator | None = None,
        device="cuda",
    ):
        super().__init__()
        self.mode, self.multires_view = mode, multires_view
        st = (stack,) if stack else ()
        pe3 = embedding_dim(multires_view, 3)

        def embed(in_dim):
            w = _lecun_normal(st + (dim_cond_embed, in_dim), generator, device)
            return WNDense(w, torch.zeros(st + (dim_cond_embed,), device=device), False)

        if mode == "idr":
            h_dim = 3 + pe3 + 3 + feature_vector_size
        elif mode == "nerf_frame_encoding":
            h_dim = pe3 + dim_frame_encoding + feature_vector_size
        elif mode == "pose_no_view":
            self.lin_pose = embed(69)
            h_dim = pe3 + 3 + dim_cond_embed + feature_vector_size
        elif mode == "pose_id_no_view":
            self.lin_pose, self.lin_id = embed(69), embed(64)
            h_dim = 3 + 3 + 2 * dim_cond_embed + feature_vector_size
        elif mode == "nerf":
            h_dim = 3 + feature_vector_size
        else:
            raise NotImplementedError(mode)
        lins = []
        for out_dim in list(dims) + [d_out]:
            w = _lecun_normal(st + (out_dim, h_dim), generator, device)
            lins.append(WNDense(w, torch.zeros(st + (out_dim,), device=device), weight_norm))
            h_dim = out_dim
        self.lins = nn.ModuleList(lins)

    @staticmethod
    def from_config(opt, dim_frame_encoding=32, stack=None, generator=None, device="cuda"):
        return RenderingNet(
            mode=opt.mode, d_out=opt.d_out, dims=tuple(opt.dims),
            feature_vector_size=opt.feature_vector_size,
            multires_view=opt.get("multires_view", -1),
            weight_norm=opt.get("weight_norm", True),
            dim_frame_encoding=dim_frame_encoding, stack=stack,
            generator=generator, device=device,
        )

    def forward(self, points, normals, view_dirs, body_pose, feature_vectors, frame_latent=None,
                id_latent=None):
        """Per-point inputs (..., N, d); `body_pose` (..., 69), `frame_latent`
        (..., c) and `id_latent` (..., 64) are per stack entry. Returns (..., N, d_out)."""
        lead = feature_vectors.shape[:-1]

        def per_entry(v):  # (..., c) -> (..., N, c)
            return v[..., None, :].expand(lead + v.shape[-1:])

        if self.mode == "idr":
            if self.multires_view > 0:
                view_dirs = positional_encoding(view_dirs, self.multires_view)
            h = torch.cat([points, view_dirs, normals, feature_vectors], dim=-1)
        elif self.mode == "nerf_frame_encoding":
            if self.multires_view > 0:
                view_dirs = positional_encoding(view_dirs, self.multires_view)
            h = torch.cat([view_dirs, per_entry(frame_latent), feature_vectors], dim=-1)
        elif self.mode == "pose_no_view":
            if self.multires_view > 0:
                points = positional_encoding(points, self.multires_view)
            bp = per_entry(self.lin_pose(body_pose[..., None, :])[..., 0, :])
            h = torch.cat([points, normals, bp, feature_vectors], dim=-1)
        elif self.mode == "pose_id_no_view":
            bp = per_entry(self.lin_pose(body_pose[..., None, :])[..., 0, :])
            il = per_entry(self.lin_id(id_latent[..., None, :])[..., 0, :])
            h = torch.cat([points, normals, bp, il, feature_vectors], dim=-1)
        else:  # nerf
            h = torch.cat([view_dirs, feature_vectors], dim=-1)
        for l, lin in enumerate(self.lins):
            h = lin(h)
            if l < len(self.lins) - 1:
                h = torch.relu(h)
        return torch.sigmoid(h)
