"""Multi-person VolSDF renderer: per-person canonical SDF fields, SMPL
deformation, a NeRF++ background and the interval composite over persons.

Counterpart of `multiply_tpu/models/renderer.py`, for every model
configuration it takes: per-person or shared shape nets (`use_person_encoder`
with identity latents), tri-plane conditioning (`cond: smpl_tri`, single or
multi-resolution with its delta-SDF), the offset head and the beta encoder,
bfloat16 sampler evaluations (`sampler_bf16`), box-clipped ray ranges
(`bbox_ray_range`), the pairwise-attenuation or the sorted composite
(`composite_matmul`), a shadow channel in the background net, and the
SMPL-surface and zero-pose extras. The persons are a leading tensor axis:
every network layer, the sampler and both kernels run once for all persons.

Training noise is explicit: `render(..., noise=...)` takes the dict that
`draw_noise` makes, so a test can hand in the numbers another framework drew.
On the card the sampler replays as CUDA graphs (`sampler_graph.py`).
"""

from __future__ import annotations

import itertools
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
from ..utils.profiling import span
from .deformer import SMPLDeformer
from ..ops.embedders import embedding_dim, positional_encoding
from .networks import COND_DIMS, BetaEncoder, ImplicitNet, OffsetHead, RenderingNet
from .ray_sampler import SamplerConfig, error_bound_sample, uniform_z_vals
from .sampler_graph import SamplerGraphs
from .triplane import TriPlane, TriPlaneMulti

OUTLIER_SDF = 4.0  # SDF given to KNN outliers at eval
N_EIKONAL = 512  # eikonal samples per person
N_ZERO_POSE = 2000  # canonical vertices per person in the zero-pose term
ID_LATENT = 64  # width of a person's identity latent and of a tri-plane feature
IMPLICIT_MODULES = ("fg_implicit", "triplane", "offset_head", "beta_encoder")  # what `_implicit` reads


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


class MultiplyRenderer(nn.Module):
    """Holds the networks and the density beta as parameters."""

    def __init__(self, conf, num_persons: int, num_frames: int,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.conf = conf
        self.P = num_persons
        self.num_frames = num_frames
        self.dim_frame = conf.get("dim_frame_encoding", 32)
        self.scene_sphere = conf.implicit_network.get("scene_bounding_sphere", 3.0)
        self.threshold = 0.05  # off-surface threshold
        self.sampler_cfg = SamplerConfig.from_config(conf.ray_sampler, self.scene_sphere)
        self.beta_min = float(conf.density.get("beta_min", 1e-4))
        loss_conf = conf.get("loss", {})
        self.smpl_surface_weight = loss_conf.get("smpl_surface_weight", 0)
        self.zero_pose_weight = loss_conf.get("zero_pose_weight", 0)
        # one shared shape net with per-person identity latents
        self.use_person_encoder = bool(conf.get("use_person_encoder", False))
        # bfloat16 for the sampler's SDF evaluations: they only place samples,
        # the render evaluations stay f32
        self.sampler_bf16 = bool(conf.get("sampler_bf16", False))
        # pairwise-attenuation composite (cost O(P^2 R S^2)); off: one stable
        # depth sort over all persons' intervals. Equal up to float association.
        self.composite_matmul = bool(conf.get("composite_matmul", True))
        # clip each person's sampling interval to its box entry and exit
        self.bbox_ray_range = bool(conf.get("bbox_ray_range", False))

        kw = dict(generator=generator, device=device)
        imp = conf.implicit_network
        cond = imp.cond
        # a shared net is conditioned on pose + identity latent whatever `cond` says
        cond_dim = 69 + ID_LATENT if self.use_person_encoder else COND_DIMS[cond]
        self.fg_implicit = ImplicitNet.from_config(
            imp, cond_dim=cond_dim, stack=None if self.use_person_encoder else num_persons, **kw
        )
        self.multi_triplane = cond == "smpl_tri" and bool(imp.get("multi_triplane", False))
        self.triplane = None
        if self.multi_triplane:
            self.triplane = TriPlaneMulti(
                ID_LATENT, tuple(imp.get("triplane_res", (128, 64, 32, 16))), stack=num_persons, **kw
            )
        elif cond == "smpl_tri":
            self.triplane = TriPlane(
                ID_LATENT, int(imp.get("triplane_resolution", 128)), stack=num_persons, **kw
            )
        self.offset_head = None
        if imp.get("offset_head", False):
            self.offset_head = OffsetHead(
                1 + imp.feature_vector_size + cond_dim + embedding_dim(imp.multires, imp.d_in),
                imp.feature_vector_size, no_head_feature=bool(imp.get("no_head_feature", False)),
                stack=num_persons, **kw,
            )
        self.beta_encoder = (
            BetaEncoder(imp.dims[0], stack=num_persons, **kw) if imp.get("beta_encoding", False) else None
        )
        if self.use_person_encoder:
            self.person_latent = nn.Parameter(torch.randn((num_persons, ID_LATENT), **kw) * 0.1)
        self.fg_render = RenderingNet.from_config(conf.rendering_network, stack=num_persons, **kw)
        bg = conf.bg_implicit_network
        self.bg_implicit = ImplicitNet.from_config(
            bg, cond_dim=self.dim_frame if bg.cond == "frame" else None, **kw
        )
        self.bg_render = RenderingNet.from_config(
            conf.bg_rendering_network, dim_frame_encoding=self.dim_frame, **kw
        )
        self.frame_latent = nn.Parameter(
            torch.randn((num_frames, self.dim_frame), **kw) * 0.01
        )
        beta_init = float(conf.density.params_init.get("beta", 0.1))
        self.beta = nn.Parameter(torch.tensor([beta_init], device=device))
        self.sampler_graphs = SamplerGraphs()  # the sampler's CUDA graphs, by input signature

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

    def draw_noise(self, num_rays: int, num_verts: int, generator=None, surface_logits=None) -> dict:
        """The training step's random numbers, drawn from `generator`.
        `surface_logits` (P, V) weight the SMPL-surface term's vertex draw."""
        cfg, P, dev = self.sampler_cfg, self.P, self.beta.device
        M = cfg.N_samples_eval * cfg.max_total_iters
        kw = dict(generator=generator, device=dev)
        noise = {
            "sampler_u": torch.rand((P, num_rays, cfg.N_samples), **kw),
            "sampler_perm": torch.stack(
                [torch.randperm(M, **kw)[: cfg.N_samples_extra] for _ in range(P)]
            ),
            "bg_u": torch.rand((num_rays, cfg.N_samples_inverse_sphere), **kw),
            "eik_idx": torch.randint(0, num_verts, (P, N_EIKONAL), **kw),
            "eik_normal": torch.randn((P, N_EIKONAL, 3), **kw),
        }
        # drawn only for the terms that are on, so the other draws stay as they were
        if self.smpl_surface_weight > 0:
            probs = torch.softmax(
                torch.zeros((P, num_verts), device=dev) if surface_logits is None else surface_logits, dim=-1
            )
            noise["surface_idx"] = torch.multinomial(probs, num_rays, replacement=True, generator=generator)
        if self.zero_pose_weight > 0:
            noise["zero_pose_idx"] = torch.randint(0, num_verts, (P, N_ZERO_POSE), **kw)
        return noise

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------

    def implicit_bundle(self, dtype: torch.dtype) -> dict:
        """Every leaf that `_implicit` reads, cast to `dtype` once and cut from
        the graph: {module name: {parameter name: tensor}}."""
        return {
            name: {k: p.detach().to(dtype) for k, p in getattr(self, name).named_parameters()}
            for name in IMPLICIT_MODULES if getattr(self, name) is not None
        }

    def _implicit(self, x, cond_vec, betas=None, bundle: dict | None = None):
        """Foreground SDF + feature of all persons: x (P, N, 3) -> (P, N, 1 + F).
        `cond_vec` (P, c) is the pose, or pose + identity latent; `betas`
        (P, 10) feeds the beta encoder where there is one. With a `bundle` of
        `implicit_bundle` the modules run on its leaves, and the inputs are
        cast to their type (the sampler's bfloat16)."""

        def call(name, *args, **kwargs):
            module = getattr(self, name)
            if bundle is None:
                return module(*args, **kwargs)
            return torch.func.functional_call(module, bundle[name], args, kwargs)

        dsdf = None
        dtype = x.dtype if bundle is None else bundle["fg_implicit"]["lins.0.weight"].dtype
        cond_vec = cond_vec.to(dtype)
        if self.triplane is not None:
            # keep the 69 pose dims (strip any identity latent), append the
            # per-point tri-plane feature sampled at x / 2 (x still f32)
            tri = call("triplane", x * 0.5)
            if self.multi_triplane:
                tri, dsdf = tri
            pose = cond_vec[..., None, :69].expand(x.shape[:-1] + (69,))
            cond_vec = torch.cat([pose, tri.to(dtype)], dim=-1)
        x = x.to(dtype)
        layer0_extra = None
        if self.beta_encoder is not None and betas is not None:
            layer0_extra = call("beta_encoder", betas.to(dtype))
        out = call("fg_implicit", x, cond_vec, layer0_extra=layer0_extra)
        if dsdf is not None and self.offset_head is None:
            # the pyramid's delta-SDF; with an offset head the head's own delta takes over
            out = torch.cat([out[..., :1] + dsdf[..., None].to(out.dtype), out[..., 1:]], dim=-1)
        if self.offset_head is not None:
            inp = positional_encoding(x, self.fg_implicit.multires)
            out = call("offset_head", out, cond_vec, inp)
        return out

    def _sdf_and_grad(self, x, cond_vec, betas, create_graph: bool):
        """Implicit forward at x (P, N, 3) plus d sdf / d x, sharing one forward."""
        with torch.enable_grad():
            if not x.requires_grad:
                x = x.detach().requires_grad_(True)
            out = self._implicit(x, cond_vec, betas)
            sdf = out[..., 0]
            (grad,) = torch.autograd.grad(
                sdf, x, torch.ones_like(sdf), create_graph=create_graph
            )
        if not create_graph:
            out, grad = out.detach(), grad.detach()
        return out, grad

    def _implicit_leaves(self) -> list[torch.Tensor]:
        """The tensors that `_implicit` reads in place: its modules' parameters and buffers."""
        modules = [getattr(self, name) for name in IMPLICIT_MODULES if getattr(self, name) is not None]
        return [t for m in modules for t in itertools.chain(m.parameters(), m.buffers())]

    def _sampler_chain(self, inp: dict, train: bool, on_points) -> dict:
        """The error-bound sampler over every person's SDF field, from the
        inputs that `_person_rays` gathers (no grad) and the implicit leaves:
        {z_vals, beta_final}. `on_points(n)` hears each evaluation's count."""
        deformer = SMPLDeformer(inp["verts_c"], inp["weights_c"])
        # the points stay f32 through the deformer (and its nn1 kernel); only
        # the implicit net's leaves, cast once for all the sampler's
        # evaluations, and its inputs go to bfloat16
        bundle16 = self.implicit_bundle(torch.bfloat16) if self.sampler_bf16 else None

        def sdf_only(pts):
            on_points(pts.shape[:-1].numel())
            with torch.no_grad():
                x_c, outlier = deformer.inverse(pts, inp["tfs"], inp["verts"])
                sdf = self._implicit(x_c, inp["cond"], inp["betas"], bundle=bundle16)[..., 0].float()
                if not train:
                    sdf = torch.where(outlier, OUTLIER_SDF, sdf)
                return sdf

        return error_bound_sample(
            self.sampler_cfg, sdf_only, inp["ray_o"], inp["ray_d"], inp["beta0"], self.P,
            noise={"u": inp["u"], "perm": inp["perm"]} if train else None,
            ray_range=None if inp["near"] is None else (inp["near"], inp["far"]),
        )

    def _person_rays(self, state: PersonState, inputs: RenderInputs, cond_vec, cond_pose,
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
        t_near, t_far, hit = ray_aabb_range(ray_o, ray_d, center - half, center + half)  # (P, R)

        betas = inputs.betas
        near = far = None
        if self.bbox_ray_range:  # rays that miss keep the full interval (they are masked anyway)
            near = torch.where(hit, t_near, 0.0).detach()
            far = torch.where(hit, t_far, 2.0 * self.scene_sphere).detach()
        sampler_inputs = {
            "ray_o": ray_o, "ray_d": ray_d, "beta0": beta0, "near": near, "far": far,
            "u": noise["sampler_u"] if train else None, "perm": noise["sampler_perm"] if train else None,
            "tfs": tfs.detach(), "verts": verts.detach(), "cond": cond_vec.detach(), "betas": betas,
            "verts_c": state.deformer.verts_c, "weights_c": state.deformer.weights_c,
        }
        with span("render.sampler"):
            samp = self.sampler_graphs(
                lambda inp, on_points: self._sampler_chain(inp, train, on_points),
                sampler_inputs, (train, self.sampler_bf16), self._implicit_leaves,
            )
        z_all = samp["z_vals"].detach()  # (P, R, S+1)
        z_vals, z_max = z_all[..., :-1], z_all[..., -1]
        S = z_vals.shape[-1]

        pts = (ray_o[:, None, :] + z_vals[..., None] * ray_d[:, None, :]).reshape(self.P, R * S, 3)
        x_c, outlier = state.deformer.inverse(pts, tfs, verts)
        out, sdf_grad_c = self._sdf_and_grad(x_c, cond_vec, betas, create_graph=torch.is_grad_enabled())
        sdf, feat = out[..., 0], out[..., 1:]
        if not train:
            sdf = torch.where(outlier, OUTLIER_SDF, sdf)
        _, m_rows = state.deformer.forward_jacobian_rows(x_c, tfs)
        # n_d = g^T J^{-1}
        n_d = covector_apply_rows(rotation_inverse_rows(m_rows), sdf_grad_c)
        normals = n_d / n_d.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        view = -ray_d[:, None, :].expand(R, S, 3).reshape(R * S, 3)
        id_latent = self.person_latent if self.use_person_encoder else cond_pose.new_zeros((self.P, ID_LATENT))
        rgb = self.fg_render(x_c, normals, view.expand(self.P, -1, -1), cond_pose, feat, id_latent=id_latent)
        return {
            "z_vals": z_vals, "z_max": z_max, "sdf": sdf.reshape(self.P, R, S),
            "x_c": x_c, "feat": feat, "normals": normals, "rgb": rgb, "hit": hit,
            "tfs": tfs, "verts": verts, "smpl_out": smpl_out,
        }

    # ------------------------------------------------------------------
    # full forward
    # ------------------------------------------------------------------

    def render(self, state: PersonState, inputs: RenderInputs, train: bool,
               noise: dict | None = None, generator: torch.Generator | None = None,
               cond_zero: bool = False) -> dict[str, Any]:
        """`cond_zero` forces the zero pose conditioning in training mode."""
        ray_d, cam_loc = get_camera_params(inputs.uv, inputs.pose, inputs.intrinsics)
        R = ray_d.shape[0]
        ray_o = cam_loc.expand(R, 3)
        if train and noise is None:
            noise = self.draw_noise(R, state.server.verts_c.shape[-2], generator, state.surface_sample_logits)

        beta = laplace_beta(self.beta[0], self.beta_min)
        beta0 = beta.detach()

        # epoch-keyed conditioning pose
        cond_pose = inputs.thetas[:, 3:] / math.pi  # (P, 69)
        if train and (cond_zero or inputs.epoch < 20 or inputs.epoch % 20 == 0):
            cond_pose = torch.zeros_like(cond_pose)
        # implicit-net conditioning: the pose, or pose + identity latent
        cond_vec = torch.cat([cond_pose, self.person_latent], dim=-1) if self.use_person_encoder else cond_pose

        pout = self._person_rays(state, inputs, cond_vec, cond_pose, ray_o, ray_d, beta0, train, noise)
        P, S = self.P, pout["z_vals"].shape[-1]

        # ---------------- interval composition over persons ----------------
        z, z_max = pout["z_vals"], pout["z_max"]
        ends = torch.cat([z[..., 1:], z_max[..., None]], dim=-1)
        delta = ends - z
        sigma = laplace_density(pout["sdf"], beta) * pout["hit"][..., None]
        comp = self.composite(sigma * delta, ends, pout["rgb"].reshape(P, R, S, 3),
                              pout["normals"].reshape(P, R, S, 3))

        # ---------------- background (NeRF++ inverse sphere) ----------------
        frame_latent = self.frame_latent[inputs.frame_idx]
        z_bg = torch.flip(self._bg_z(R, noise["bg_u"] if train else None), dims=(-1,))
        bg_rgb_values = self._render_background(ray_o, ray_d, z_bg, frame_latent)

        fg_rgb_values, bg_transmittance = comp["fg_rgb_values"], comp["bg_transmittance"]
        out: dict[str, Any] = {
            "rgb_values": fg_rgb_values + bg_transmittance[:, None] * bg_rgb_values,
            "fg_rgb_values": fg_rgb_values + bg_transmittance[:, None],
            "normal_values": comp["normal_values"],
            "acc_map": comp["acc_map"],
            "acc_person_list": comp["acc_person"],
            "bg_transmittance": bg_transmittance,
            "weights": comp["weights"],
            "hit": pout["hit"],
        }
        if train:
            out.update(self._training_extras(state, inputs, pout, cond_vec, noise))
        return out

    # -- helpers -------------------------------------------------------

    def composite(self, fe: torch.Tensor, ends: torch.Tensor, rgb: torch.Tensor, normals: torch.Tensor) -> dict:
        """The persons' intervals composited along each ray: free energy `fe`
        and far ends `ends` (P, R, S), colours and normals (P, R, S, 3).
        Returns the foreground colour and normal, `acc_map`, `acc_person`
        (R, P), the background's transmittance and the weights (R, P * S)."""
        P, R, S = fe.shape
        if self.composite_matmul:
            # pairwise attenuation: weight of interval i of person p = alpha_i *
            # exp(-(own exclusive prefix free energy + sum over q != p of fe_q on
            # intervals ending before end_p[i])); equals the depth-sorted
            # composite with ties resolved person-major (<= for q < p, < for
            # q > p). Full f32: an underestimated cross sum lets acc_map pass 1.
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
        else:
            # one stable sort of all persons' intervals by their far end (ties
            # stay person-major), then transmittance in sorted order
            def flat(x):  # (P, R, S, ...) -> (R, P * S, ...)
                return x.movedim(0, 1).reshape((R, P * S) + x.shape[3:])

            _, order = torch.sort(flat(ends), dim=-1, stable=True)
            fe_s = flat(fe).gather(-1, order)
            order3 = order[..., None].expand(R, P * S, 3)
            rgb_s, nrm_s = flat(rgb).gather(1, order3), flat(normals).gather(1, order3)
            pid_s = order // S  # the flat layout is person-major
            shifted = torch.cat([torch.zeros((R, 1), device=fe.device), fe_s[:, :-1]], dim=-1)
            weights = (1.0 - torch.exp(-fe_s)) * torch.exp(-torch.cumsum(shifted, dim=-1))  # (R, P * S)
            bg_transmittance = torch.exp(-fe_s.sum(-1))
            fg_rgb_values = (weights[..., None] * rgb_s).sum(-2)
            normal_values = (weights[..., None] * nrm_s).sum(-2)
            acc_map = weights.sum(-1)
            person = torch.arange(P, device=fe.device)
            acc_person = (weights[..., None] * (pid_s[..., None] == person)).sum(1)  # (R, P)

        return {"fg_rgb_values": fg_rgb_values, "normal_values": normal_values, "acc_map": acc_map,
                "acc_person": acc_person, "bg_transmittance": bg_transmittance, "weights": weights}

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
        )
        if bg_rgb.shape[-1] == 4:  # a shadow channel darkens the colour
            bg_rgb = (1.0 - bg_rgb[:, 3:]) * bg_rgb[:, :3]
        bg_rgb = bg_rgb.reshape(R, Nb, 3)

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
        """In/off-surface tests against the baked canonical grid, eikonal
        gradients, and the SMPL-surface and zero-pose terms where they are on.
        `cond_vec` is the implicit net's conditioning (pose, or pose + identity)."""
        S = pout["sdf"].shape[-1]
        betas = inputs.betas
        g = state.cano_grid
        # least canonical distance along each ray, (P, R): one launch on the card
        dmin = grid_trilinear(g["grid"], pout["x_c"].detach(), g["origin"], g["spacing"], group=S)
        off_p = (dmin > self.threshold) | ~pout["hit"]  # non-hitting rays: off, not in
        in_p = (dmin <= 0.0) & pout["hit"]

        # eikonal: jitter around random canonical verts of each person
        verts_c = state.server.verts_c
        idx = noise["eik_idx"][..., None].expand(-1, -1, 3)
        sample = verts_c.gather(1, idx) + noise["eik_normal"] * 0.01
        _, grad_theta = self._sdf_and_grad(sample, cond_vec, betas, create_graph=torch.is_grad_enabled())

        # SMPL-surface anchoring: sampled posed vertices should not lie outside the field
        smpl_surface_loss = verts_c.new_zeros(())
        if self.smpl_surface_weight > 0:
            verts = pout["verts"]
            sample = verts.gather(1, noise["surface_idx"][..., None].expand(-1, -1, 3))
            x_c, _ = state.deformer.inverse(sample, pout["tfs"], verts)
            sdf = self._implicit(x_c, cond_vec, betas)[..., 0]  # (P, R)
            viol = sdf > 0.02
            per_person = torch.where(viol, sdf - 0.02, 0.0).sum(-1) / viol.sum(-1).clamp_min(1)
            smpl_surface_loss = per_person.sum()

        # zero-pose consistency: on canonical surface points the field under
        # the current pose conditioning should match the zero-pose conditioning
        zero_pose_loss = verts_c.new_zeros(())
        if self.zero_pose_weight > 0:
            sample = verts_c.gather(1, noise["zero_pose_idx"][..., None].expand(-1, -1, 3))
            out_pred = self._implicit(sample, cond_vec, betas)
            cond_zero = torch.cat([torch.zeros_like(cond_vec[..., :69]), cond_vec[..., 69:]], dim=-1)
            diff = (out_pred - self._implicit(sample, cond_zero, betas)).abs()
            zero_pose_loss = (diff[..., :1].mean(dim=(-1, -2)) + diff[..., 1:].mean(dim=(-1, -2))).sum()

        return {
            "index_off_surface": off_p.all(0),
            "index_in_surface": in_p.any(0),
            "grad_theta": grad_theta.reshape(-1, 3),
            "smpl_surface_loss": smpl_surface_loss,
            "zero_pose_loss": zero_pose_loss,
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
