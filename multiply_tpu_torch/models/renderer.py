"""Multi-person VolSDF renderer: per-person canonical SDF fields, SMPL
deformation, a NeRF++ background and the pairwise-attenuation composite.

Counterpart of `multiply_tpu/models/renderer.py` for its default f32 path
(`composite_matmul=True`, no sampler_bf16, no bbox ray range, no person
encoder / tri-plane / offset head / beta encoder; a config asking for one of
those raises NotImplementedError). The persons are a leading tensor axis:
every network layer, the sampler and both kernels run once for all persons.

Training noise is explicit: `render(..., noise=...)` takes the dict that
`draw_noise` makes, so a test can hand in the numbers another framework drew.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch import nn

from ..body.server import SMPLServer, smpl_server_forward, stack_servers
from ..ops.density import laplace_beta, laplace_density
from ..ops.grid_cuda import grid_trilinear
from ..ops.mesh_ops import ray_aabb_range, sdf_grid
from ..ops.skinning import covector_apply_rows, rotation_inverse_rows
from ..utils.cameras import get_camera_params
from .deformer import SMPLDeformer
from .networks import ImplicitNet, RenderingNet
from .ray_sampler import SamplerConfig, error_bound_sample, uniform_z_vals

OUTLIER_SDF = 4.0  # SDF given to KNN outliers at eval
N_EIKONAL = 512  # eikonal samples per person


class PersonState(NamedTuple):
    """Per-person static state, stacked over persons (leading axis P)."""

    server: SMPLServer
    deformer: SMPLDeformer
    cano_grid: dict  # {"grid": (P, r, r, r), "origin": (P, 3), "spacing": (P, 3)}
    surface_sample_logits: torch.Tensor  # (P, V)


class RenderInputs(NamedTuple):
    """One frame's render request (single camera, R rays)."""

    uv: torch.Tensor  # (R, 2)
    pose: torch.Tensor  # (4, 4) cam-to-world
    intrinsics: torch.Tensor  # (3, 3)
    scale: torch.Tensor  # (P,)
    transl: torch.Tensor  # (P, 3)
    thetas: torch.Tensor  # (P, 72)
    betas: torch.Tensor  # (P, 10)
    frame_idx: int
    epoch: int


_UNPORTED = {
    "use_person_encoder": False,
    "sampler_bf16": False,
    "bbox_ray_range": False,
    "composite_matmul": True,
}


class MultiplyRenderer(nn.Module):
    """Holds the networks and the density beta as parameters."""

    def __init__(self, conf, num_persons: int, num_frames: int,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        for key, supported in _UNPORTED.items():
            if bool(conf.get(key, supported)) != supported:
                raise NotImplementedError(f"{key}={conf.get(key)} is not ported yet")
        for key in ("smpl_surface_weight", "zero_pose_weight"):
            if conf.get("loss", {}).get(key, 0):
                raise NotImplementedError(f"loss.{key} > 0 is not ported yet")
        self.conf = conf
        self.P = num_persons
        self.num_frames = num_frames
        self.dim_frame = conf.get("dim_frame_encoding", 32)
        self.scene_sphere = conf.implicit_network.get("scene_bounding_sphere", 3.0)
        self.threshold = 0.05  # off-surface threshold
        self.sampler_cfg = SamplerConfig.from_config(conf.ray_sampler, self.scene_sphere)
        self.beta_min = float(conf.density.get("beta_min", 1e-4))
        if conf.bg_rendering_network.d_out != 3:
            raise NotImplementedError("a shadow channel in the background net is not ported yet")

        kw = dict(generator=generator, device=device)
        self.fg_implicit = ImplicitNet.from_config(conf.implicit_network, stack=num_persons, **kw)
        self.fg_render = RenderingNet.from_config(conf.rendering_network, stack=num_persons, **kw)
        self.bg_implicit = ImplicitNet.from_config(conf.bg_implicit_network, **kw)
        self.bg_render = RenderingNet.from_config(
            conf.bg_rendering_network, dim_frame_encoding=self.dim_frame, **kw
        )
        self.frame_latent = nn.Parameter(
            torch.randn((num_frames, self.dim_frame), **kw) * 0.01
        )
        beta_init = float(conf.density.params_init.get("beta", 0.1))
        self.beta = nn.Parameter(torch.tensor([beta_init], device=device))

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def build_person_state(self, servers: list[SMPLServer], surface_logits=None,
                           grid_res: int = 64) -> PersonState:
        """Bake each person's canonical SDF grid and stack the state over persons."""
        grids = [sdf_grid(s.verts_c, s.model.faces, res=grid_res) for s in servers]
        server = stack_servers(servers)
        logits = (
            torch.stack([torch.as_tensor(l, dtype=torch.float32) for l in surface_logits])
            if surface_logits is not None
            else torch.zeros(server.verts_c.shape[:2])
        ).to(server.verts_c.device)
        return PersonState(
            server=server,
            deformer=SMPLDeformer.create(server),
            cano_grid={k: torch.stack([g[k] for g in grids]) for k in grids[0]},
            surface_sample_logits=logits,
        )

    def draw_noise(self, num_rays: int, num_verts: int, generator=None) -> dict:
        """The training step's random numbers, drawn from `generator`."""
        cfg, P, dev = self.sampler_cfg, self.P, self.beta.device
        M = cfg.N_samples_eval * cfg.max_total_iters
        kw = dict(generator=generator, device=dev)
        return {
            "sampler_u": torch.rand((P, num_rays, cfg.N_samples), **kw),
            "sampler_perm": torch.stack(
                [torch.randperm(M, **kw)[: cfg.N_samples_extra] for _ in range(P)]
            ),
            "bg_u": torch.rand((num_rays, cfg.N_samples_inverse_sphere), **kw),
            "eik_idx": torch.randint(0, num_verts, (P, N_EIKONAL), **kw),
            "eik_normal": torch.randn((P, N_EIKONAL, 3), **kw),
        }

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------

    def _sdf_and_grad(self, x, cond_vec, create_graph: bool):
        """Implicit forward at x (P, N, 3) plus d sdf / d x, sharing one forward."""
        with torch.enable_grad():
            if not x.requires_grad:
                x = x.detach().requires_grad_(True)
            out = self.fg_implicit(x, cond_vec)
            sdf = out[..., 0]
            (grad,) = torch.autograd.grad(
                sdf, x, torch.ones_like(sdf), create_graph=create_graph
            )
        if not create_graph:
            out, grad = out.detach(), grad.detach()
        return out, grad

    def _person_rays(self, state: PersonState, inputs: RenderInputs, cond_vec,
                     ray_o, ray_d, beta0, train: bool, noise) -> dict:
        """SMPL, sampling, SDF, color and normals for all persons at once."""
        R = ray_o.shape[0]
        smpl_out = smpl_server_forward(
            state.server, inputs.scale, inputs.transl, inputs.thetas, inputs.betas
        )
        tfs, verts = smpl_out["smpl_tfs"], smpl_out["smpl_verts"]

        # padded AABB hit mask in place of the reference's OBB ray culling
        vmax, vmin = verts.max(-2).values, verts.min(-2).values
        center, half = 0.5 * (vmax + vmin), 0.5 * (vmax - vmin) * 1.2
        _, _, hit = ray_aabb_range(ray_o, ray_d, center - half, center + half)  # (P, R)

        tfs_ng, verts_ng, cond_ng = tfs.detach(), verts.detach(), cond_vec.detach()

        def sdf_only(pts):
            with torch.no_grad():
                x_c, outlier = state.deformer.inverse(pts, tfs_ng, verts_ng)
                sdf = self.fg_implicit(x_c, cond_ng)[..., 0]
                if not train:
                    sdf = torch.where(outlier, OUTLIER_SDF, sdf)
                return sdf

        samp = error_bound_sample(
            self.sampler_cfg, sdf_only, ray_o, ray_d, beta0, self.P,
            noise={"u": noise["sampler_u"], "perm": noise["sampler_perm"]} if train else None,
        )
        z_all = samp["z_vals"].detach()  # (P, R, S+1)
        z_vals, z_max = z_all[..., :-1], z_all[..., -1]
        S = z_vals.shape[-1]

        pts = (ray_o[:, None, :] + z_vals[..., None] * ray_d[:, None, :]).reshape(self.P, R * S, 3)
        x_c, outlier = state.deformer.inverse(pts, tfs, verts)
        out, sdf_grad_c = self._sdf_and_grad(x_c, cond_vec, create_graph=torch.is_grad_enabled())
        sdf, feat = out[..., 0], out[..., 1:]
        if not train:
            sdf = torch.where(outlier, OUTLIER_SDF, sdf)
        _, m_rows = state.deformer.forward_jacobian_rows(x_c, tfs)
        # n_d = g^T J^{-1}
        n_d = covector_apply_rows(rotation_inverse_rows(m_rows), sdf_grad_c)
        normals = n_d / n_d.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        rgb = self.fg_render(x_c, normals, None, cond_vec, feat)
        return {
            "z_vals": z_vals, "z_max": z_max, "sdf": sdf.reshape(self.P, R, S),
            "x_c": x_c, "feat": feat, "normals": normals, "rgb": rgb, "hit": hit,
            "tfs": tfs, "verts": verts, "smpl_out": smpl_out,
        }

    # ------------------------------------------------------------------
    # full forward
    # ------------------------------------------------------------------

    def render(self, state: PersonState, inputs: RenderInputs, train: bool,
               noise: dict | None = None, generator: torch.Generator | None = None) -> dict[str, Any]:
        ray_d, cam_loc = get_camera_params(inputs.uv, inputs.pose, inputs.intrinsics)
        R = ray_d.shape[0]
        ray_o = cam_loc.expand(R, 3)
        if train and noise is None:
            noise = self.draw_noise(R, state.server.verts_c.shape[-2], generator)

        beta = laplace_beta(self.beta[0], self.beta_min)
        beta0 = beta.detach()

        # epoch-keyed conditioning pose
        cond_pose = inputs.thetas[:, 3:] / math.pi  # (P, 69)
        if train and (inputs.epoch < 20 or inputs.epoch % 20 == 0):
            cond_pose = torch.zeros_like(cond_pose)

        pout = self._person_rays(state, inputs, cond_pose, ray_o, ray_d, beta0, train, noise)
        P, S = self.P, pout["z_vals"].shape[-1]

        # ---------------- pairwise-attenuation composite ----------------
        # weight of interval i of person p = alpha_i * exp(-(own exclusive
        # prefix free energy + sum over q != p of fe_q on intervals ending
        # before end_p[i])); equals the depth-sorted composite with ties
        # resolved person-major (<= for q < p, < for q > p). Full f32.
        z, z_max = pout["z_vals"], pout["z_max"]
        ends = torch.cat([z[..., 1:], z_max[..., None]], dim=-1)
        delta = ends - z
        sigma = laplace_density(pout["sdf"], beta) * pout["hit"][..., None]
        fe = sigma * delta  # (P, R, S)
        rgb = pout["rgb"].reshape(P, R, S, 3)
        normals = pout["normals"].reshape(P, R, S, 3)

        own_prefix = torch.cumsum(fe, dim=-1) - fe
        cross = []
        for p in range(P):
            acc = torch.zeros((R, S), device=fe.device)
            for q in range(P):
                if q == p:
                    continue
                if q < p:
                    m = ends[q][:, None, :] <= ends[p][:, :, None]
                else:
                    m = ends[q][:, None, :] < ends[p][:, :, None]
                acc = acc + (m.to(fe.dtype) @ fe[q][..., None])[..., 0]
            cross.append(acc)
        cross = torch.stack(cross)
        w_p = (1.0 - torch.exp(-fe)) * torch.exp(-(own_prefix + cross))  # (P, R, S)
        bg_transmittance = torch.exp(-fe.sum(dim=(0, -1)))
        fg_rgb_values = torch.einsum("prs,prsc->rc", w_p, rgb)
        normal_values = torch.einsum("prs,prsc->rc", w_p, normals)
        acc_person = w_p.sum(-1).T  # (R, P)
        acc_map = acc_person.sum(-1)
        weights = w_p.permute(1, 0, 2).reshape(R, P * S)

        # ---------------- background (NeRF++ inverse sphere) ----------------
        frame_latent = self.frame_latent[inputs.frame_idx]
        z_bg = torch.flip(self._bg_z(R, noise["bg_u"] if train else None), dims=(-1,))
        bg_rgb_values = self._render_background(ray_o, ray_d, z_bg, frame_latent)

        out: dict[str, Any] = {
            "rgb_values": fg_rgb_values + bg_transmittance[:, None] * bg_rgb_values,
            "fg_rgb_values": fg_rgb_values + bg_transmittance[:, None],
            "normal_values": normal_values,
            "acc_map": acc_map,
            "acc_person_list": acc_person,
            "bg_transmittance": bg_transmittance,
            "weights": weights,
            "hit": pout["hit"],
        }
        if train:
            out.update(self._training_extras(state, inputs, pout, cond_pose, noise))
        return out

    # -- helpers -------------------------------------------------------

    def _bg_z(self, R: int, u: torch.Tensor | None) -> torch.Tensor:
        dev = self.beta.device
        z = uniform_z_vals(
            torch.zeros((R, 1), device=dev), torch.ones((R, 1), device=dev),
            self.sampler_cfg.N_samples_inverse_sphere, u,
        )
        return z * (1.0 / self.scene_sphere)

    def _render_background(self, ray_o, ray_d, z_bg, frame_latent):
        """NeRF++ inverse-sphere background color per ray (R, 3)."""
        R, Nb = z_bg.shape
        bg_dirs = ray_d[:, None, :].expand(R, Nb, 3)
        bg_locs = ray_o[:, None, :].expand(R, Nb, 3)
        bg_pts = depth2pts_outside(bg_locs, bg_dirs, z_bg, self.scene_sphere)
        bg_out = self.bg_implicit(bg_pts.reshape(-1, 4), frame_latent)
        bg_sdf, bg_feat = bg_out[:, :1], bg_out[:, 1:]
        bg_rgb = self.bg_render(
            None, None, bg_dirs.reshape(-1, 3), None, bg_feat, frame_latent=frame_latent
        ).reshape(R, Nb, 3)

        # AbsDensity volume rendering in flipped (1 -> 0) order
        bg_density = bg_sdf.abs().reshape(R, Nb)
        bg_dists = torch.cat(
            [z_bg[:, :-1] - z_bg[:, 1:], torch.full((R, 1), 1e10, device=z_bg.device)], dim=-1
        )
        fe = bg_dists * bg_density
        shifted = torch.cat([torch.zeros((R, 1), device=fe.device), fe[:, :-1]], dim=-1)
        bg_weights = (1.0 - torch.exp(-fe)) * torch.exp(-torch.cumsum(shifted, dim=-1))
        return (bg_weights[..., None] * bg_rgb).sum(1)

    def _training_extras(self, state: PersonState, inputs, pout, cond_vec, noise):
        """In/off-surface tests against the baked canonical grid, and eikonal gradients."""
        S = pout["sdf"].shape[-1]
        g = state.cano_grid
        # least canonical distance along each ray, (P, R): one launch on the card
        dmin = grid_trilinear(g["grid"], pout["x_c"].detach(), g["origin"], g["spacing"], group=S)
        off_p = (dmin > self.threshold) | ~pout["hit"]  # non-hitting rays: off, not in
        in_p = (dmin <= 0.0) & pout["hit"]

        # eikonal: jitter around random canonical verts of each person
        verts_c = state.server.verts_c
        idx = noise["eik_idx"][..., None].expand(-1, -1, 3)
        sample = verts_c.gather(1, idx) + noise["eik_normal"] * 0.01
        _, grad_theta = self._sdf_and_grad(sample, cond_vec, create_graph=torch.is_grad_enabled())
        return {
            "index_off_surface": off_p.all(0),
            "index_in_surface": in_p.any(0),
            "grad_theta": grad_theta.reshape(-1, 3),
            "epoch": inputs.epoch,
        }


def depth2pts_outside(ray_o, ray_d, depth, r: float) -> torch.Tensor:
    """NeRF++ inverse-sphere parameterization: depth is 1/distance in [0, 1/r];
    returns (..., 4) points on the unit sphere + inverse depth."""
    o_dot_d = (ray_d * ray_o).sum(-1)
    under_sqrt = o_dot_d**2 - ((ray_o**2).sum(-1) - r**2)
    d_sphere = torch.sqrt(under_sqrt.clamp_min(0.0)) - o_dot_d
    p_sphere = ray_o + d_sphere[..., None] * ray_d
    p_mid = ray_o - o_dot_d[..., None] * ray_d
    p_mid_norm = p_mid.norm(dim=-1)

    rot_axis = torch.linalg.cross(ray_o, p_sphere)
    rot_axis = rot_axis / rot_axis.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    phi = torch.asin((p_mid_norm / r).clamp(-1.0, 1.0))
    theta = torch.asin((p_mid_norm * depth).clamp(-1.0, 1.0))
    rot_angle = (phi - theta)[..., None]
    cosr, sinr = torch.cos(rot_angle), torch.sin(rot_angle)
    p_new = (
        p_sphere * cosr
        + torch.linalg.cross(rot_axis, p_sphere) * sinr
        + rot_axis * (rot_axis * p_sphere).sum(-1, keepdim=True) * (1.0 - cosr)
    )
    p_new = p_new / p_new.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.cat([p_new, depth[..., None]], dim=-1)
