"""Validation and test rendering: chunked full-image renders, PSNR,
foreground, normal and per-person maps, canonical and deformed mesh files.

Counterpart of `multiply_tpu/engine/evaluator.py`, with the same directory
layout:
    test_rendering/%04d.png, test_fg_rendering/, test_normal/, test_mask/,
    test_instance_mask/<p>/%04d.png, test_mesh/<p>/<idx>_canonical|_deformed.ply

With a ray group (`group`, as JAX's `mesh=`), the chunk is rounded up to a
multiple of the ranks and each rank renders its share of every chunk; the
shares are gathered in rank order. Every rank calls `render_image`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..body.server import smpl_server_forward
from ..models.deformer import SMPLDeformer
from ..models.renderer import MultiplyRenderer, PersonState, RenderInputs
from ..utils.io import write_png
from .mesh_export import generate_mesh, save_ply

RENDER_KEYS = ("rgb_values", "fg_rgb_values", "normal_values", "acc_map", "acc_person_list")


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((pred - gt) ** 2))
    return -10.0 * np.log10(mse + 1e-10)


class Evaluator:
    def __init__(self, renderer: MultiplyRenderer, person_state: PersonState, servers: list,
                 pixel_per_batch: int = 512, group=None):
        self.renderer = renderer
        self.state = person_state
        self.servers = servers
        self.group = group
        if group is not None:
            pixel_per_batch = -(-pixel_per_batch // group.world) * group.world
        self.chunk = pixel_per_batch

    def render_image(self, body_tables, item: dict, epoch: int = 10_000,
                     person_state: PersonState | None = None) -> dict:
        """Render every pixel of `item` in chunks of `pixel_per_batch` rays with
        the renderer's current weights and the frame's rows of `body_tables`."""
        state = person_state if person_state is not None else self.state
        dev = self.renderer.beta.device
        H, W = item["img_size"]
        uv_full = torch.as_tensor(np.asarray(item["uv"], np.float32), device=dev)
        idx = int(item["idx"])

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        outs = {k: [] for k in RENDER_KEYS}
        with torch.no_grad():
            for chunk in uv_full.split(self.chunk):
                inputs = RenderInputs(
                    uv=chunk, pose=t(item["pose"]), intrinsics=t(item["intrinsics"]), scale=t(item["smpl_scale"]),
                    transl=body_tables.transl[:, idx], thetas=body_tables.thetas(idx),
                    betas=body_tables.betas[:, 0], frame_idx=idx, epoch=epoch,
                )
                out = self.renderer.render(state, inputs, train=False) if self.group is None \
                    else self._render_share(state, inputs)
                for k in RENDER_KEYS:
                    outs[k].append(out[k])
        merged = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        merged["rgb_image"] = merged["rgb_values"].reshape(H, W, 3)
        merged["fg_image"] = merged["fg_rgb_values"].reshape(H, W, 3)
        merged["normal_image"] = (merged["normal_values"].reshape(H, W, 3) + 1) / 2
        merged["mask_image"] = merged["acc_map"].reshape(H, W)
        merged["instance_images"] = merged["acc_person_list"].reshape(H, W, -1)
        if "rgb" in item:
            merged["psnr"] = psnr(merged["rgb_values"], np.asarray(item["rgb"], np.float32))
        return merged

    def _render_share(self, state: PersonState, inputs: RenderInputs) -> dict:
        """Render this rank's share of a chunk (the last chunk padded to a
        multiple of the ranks by repeating its last pixel) and gather the
        shares: one collective of every output's columns."""
        from ..parallel import shard_render_inputs

        n, g = inputs.uv.shape[0], self.group
        pad = -n % g.world
        uv = torch.cat([inputs.uv, inputs.uv[-1:].expand(pad, 2)]) if pad else inputs.uv
        out = self.renderer.render(state, shard_render_inputs(inputs._replace(uv=uv), g.rank, g.world), train=False)
        cols = [out[k].reshape(out[k].shape[0], -1) for k in RENDER_KEYS]
        whole = g.all_gather(torch.cat(cols, 1))[:n]
        parts = whole.split([c.shape[1] for c in cols], 1)
        return {k: p.reshape((n,) + out[k].shape[1:]) for k, p in zip(RENDER_KEYS, parts)}

    def export_meshes(self, canonical_sdf_fns: list, body_tables, deformers: SMPLDeformer, frame_idx: int,
                      scale: float, out_dir: str, res_up: int = 4, deform_k: int = 7) -> None:
        """Canonical and deformed PLY per person; the deformer takes K=7
        neighbours here, as at export in the reference."""
        dev = self.renderer.beta.device
        for p, sdf_fn in enumerate(canonical_sdf_fns):
            verts_c, faces = generate_mesh(sdf_fn, self.servers[p].verts_c.cpu().numpy(), res_up=res_up)
            pdir = os.path.join(out_dir, "test_mesh", str(p))
            os.makedirs(pdir, exist_ok=True)
            save_ply(os.path.join(pdir, f"{frame_idx:04d}_canonical.ply"), verts_c, faces)

            with torch.no_grad():
                out = smpl_server_forward(
                    self.servers[p], torch.tensor(float(scale), device=dev), body_tables.transl[p, frame_idx],
                    body_tables.thetas(frame_idx)[p], body_tables.betas[p, 0],
                )
                deformer = SMPLDeformer(*(x[p] for x in deformers))
                # 512^3 canonical meshes reach millions of vertices: warp in chunks
                verts_d = np.concatenate([
                    deformer.forward(torch.as_tensor(verts_c[s : s + 100_000], device=dev), out["smpl_tfs"],
                                     k=deform_k).cpu().numpy()
                    for s in range(0, len(verts_c), 100_000)
                ]) if len(verts_c) else verts_c
            save_ply(os.path.join(pdir, f"{frame_idx:04d}_deformed.ply"), verts_d, faces)

    def save_outputs(self, out_dir: str, frame_idx: int, merged: dict, gt: np.ndarray | None = None) -> None:
        def w(sub, img):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
            write_png(os.path.join(out_dir, sub, f"{frame_idx:04d}.png"), (np.clip(img, 0, 1) * 255).astype(np.uint8))

        rgb = merged["rgb_image"]
        if gt is not None:
            rgb = np.concatenate([gt, rgb], axis=1)
        w("test_rendering", rgb)
        w("test_fg_rendering", merged["fg_image"])
        w("test_normal", merged["normal_image"])
        w("test_mask", merged["mask_image"])
        for p in range(merged["instance_images"].shape[-1]):
            w(os.path.join("test_instance_mask", str(p)), merged["instance_images"][..., p])
