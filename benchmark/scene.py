"""The training directory that a cell's trainer reads, made from the seed.

A preprocessed multi-person sequence in the layout `Hi4DSequence` reads:
PNG frames, one PNG mask per person and frame, `cameras_normalize.npz`,
`poses.npy`, `normalize_trans.npy` and `mean_shape.npy`. The persons are the
configuration's SMPL body, posed by seeded smooth motion, side by side before
one fixed camera; the masks and the frames come from an exact z-buffer of
the posed meshes. Every seed gives the same sizes (frames, persons, image);
the seed moves the poses, the placement and the colours. The persons' shapes
(betas) come from the configuration's `body_seed`: `smpl_init` pretrains on
the first person's canonical body, so that one pretraining, cached once a
checkout, serves every seed.

The SMPL pickles depend on the configuration alone (its `body_seed`), so they
are written once into a cache directory inside the checkout.
"""

from __future__ import annotations

import math
import os
import shutil
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .reference.server import SMPLServer, canonical_pose_params, smpl_server_forward
from .reference.smpl import load_smpl_model

PERSON_COLORS = np.array([[0.80, 0.32, 0.25], [0.25, 0.42, 0.82], [0.30, 0.75, 0.32], [0.75, 0.70, 0.20]])


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W) or (H, W, 3) uint8 array as an 8-bit PNG, every row under
    filter 0 (the filter the port's own preprocessing writes)."""
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    color_type = {1: 0, 3: 2}[C]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def smpl_dir(scene_cfg: dict, cache_root: str) -> str:
    """The configuration's SMPL pickles (SMPL_{MALE,FEMALE,NEUTRAL}.pkl), written
    by the port's `write_synthetic_smpl_dir` once per checkout and body."""
    from multiply_tpu_torch.body.synthetic_pickle import write_synthetic_smpl_dir

    seed, verts = int(scene_cfg["body_seed"]), int(scene_cfg["body_verts"])
    out = os.path.join(cache_root, "smpl", f"seed{seed}_v{verts}")
    if not os.path.exists(os.path.join(out, "SMPL_NEUTRAL.pkl")):
        tmp = f"{out}.tmp{os.getpid()}"
        write_synthetic_smpl_dir(tmp, num_verts=verts, seed=seed)
        shutil.rmtree(out, ignore_errors=True)
        os.replace(tmp, out)
    return out


def camera(scene_cfg: dict) -> np.ndarray:
    """The world-to-image projection (4, 4) of the fixed camera at z =
    -distance looking down +z; the principal point is sub-pixel."""
    H, W, f = int(scene_cfg["height"]), int(scene_cfg["width"]), float(scene_cfg["focal"])
    K = np.array([[f, 0.0, W / 2 + 0.37], [0.0, f, H / 2 + 0.23], [0.0, 0.0, 1.0]])
    Rt = np.concatenate([np.eye(3), np.array([[0.0], [0.0], [float(scene_cfg["camera_distance"])]])], axis=1)
    P = np.eye(4)
    P[:3, :4] = K @ Rt
    return P


def draw_motion(scene_cfg: dict, num_person: int, rng: np.random.Generator):
    """(poses (F, P, 72), transl (F, P, 3), betas (P, 10)): upright bodies side
    by side, each swaying and moving its joints along seeded sinusoids; the
    shapes from the configuration's `body_seed`."""
    F = int(scene_cfg["frames"])
    betas = np.random.default_rng(int(scene_cfg["body_seed"])).standard_normal((num_person, 10)) * 0.3
    base = canonical_pose_params(dtype=torch.float64, device="cpu").numpy()
    t = np.arange(F)[:, None, None]
    amp = rng.uniform(0.0, 0.25, (1, num_person, 69))
    freq = rng.uniform(0.05, 0.3, (1, num_person, 69))
    phase = rng.uniform(0.0, 2 * math.pi, (1, num_person, 69))
    poses = np.zeros((F, num_person, 72))
    poses[..., 0] = math.pi  # upright before a y-down image
    poses[..., 3:] = base[3:] + amp * np.sin(freq * t + phase)
    spacing = float(scene_cfg["person_spacing"])
    transl = np.zeros((F, num_person, 3))
    transl[..., 0] = (np.arange(num_person) - (num_person - 1) / 2) * spacing
    transl[..., 0] += 0.05 * np.sin(0.1 * t[..., 0] + rng.uniform(0, 2 * math.pi, num_person))
    transl[..., 1] = -0.15
    transl[..., 2] = rng.uniform(-0.2, 0.2, num_person)
    return poses.astype(np.float32), transl.astype(np.float32), betas.astype(np.float32)


def zbuffer(verts_px: torch.Tensor, faces: torch.Tensor, H: int, W: int, span: int, chunk: int = 2048) -> torch.Tensor:
    """Depth at each pixel centre of one mesh, inf where it is missed:
    verts_px (V, 3) as (x pixel, y pixel, depth), faces (F, 3); `span` bounds
    every face's pixel box (`face_span`)."""
    tri = verts_px[faces]  # (F, 3, 3)
    lo = tri[..., :2].amin(1).floor().clamp_min(0)
    depth = torch.full((H * W,), math.inf, device=verts_px.device)
    off = torch.arange(span, device=tri.device, dtype=tri.dtype)
    for s in range(0, len(tri), chunk):
        t, l = tri[s:s + chunk], lo[s:s + chunk]
        px = (l[:, None, None, 0] + off[None, None, :]).expand(-1, span, span)
        py = (l[:, None, None, 1] + off[None, :, None]).expand(-1, span, span)
        a, b, c = t[:, None, None, 0], t[:, None, None, 1], t[:, None, None, 2]
        area = (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])
        w0 = ((b[..., 0] - px) * (c[..., 1] - py) - (b[..., 1] - py) * (c[..., 0] - px)) / area
        w1 = ((c[..., 0] - px) * (a[..., 1] - py) - (c[..., 1] - py) * (a[..., 0] - px)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area.abs() > 1e-12) & (px < W) & (py < H)
        z = torch.where(inside, w0 * a[..., 2] + w1 * b[..., 2] + w2 * c[..., 2], math.inf)
        idx = (py.clamp_max(H - 1) * W + px.clamp_max(W - 1)).long()
        depth.scatter_reduce_(0, idx.reshape(-1), z.reshape(-1), reduce="amin")
    return depth.reshape(H, W)


def project(verts: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """(..., V, 3) world points -> (..., V, 3) as (x pixel, y pixel, depth)."""
    h = torch.cat([verts, torch.ones_like(verts[..., :1])], -1) @ P[:3].T
    return torch.stack([h[..., 0] / h[..., 2], h[..., 1] / h[..., 2], h[..., 2]], -1)


def make_scene(scene_cfg: dict, num_person: int, seed: int, body_dir: str, device) -> dict:
    """Every array of the sequence: images (F, H, W, 3) uint8, masks (F, P, H, W)
    bool, poses, transl, betas and the projection P."""
    rng = np.random.default_rng(seed)
    F, H, W = int(scene_cfg["frames"]), int(scene_cfg["height"]), int(scene_cfg["width"])
    poses, transl, betas = draw_motion(scene_cfg, num_person, rng)
    P = camera(scene_cfg)
    body = load_smpl_model(body_dir, "neutral", device=device)
    Pt = torch.as_tensor(P, dtype=torch.float32, device=device)
    with torch.no_grad():
        posed = []
        for p in range(num_person):
            server = SMPLServer.create(body, betas=betas[p])
            out = smpl_server_forward(
                server, torch.ones(F, device=device), torch.as_tensor(transl[:, p], device=device),
                torch.as_tensor(poses[:, p], device=device), torch.as_tensor(betas[p], device=device).expand(F, 10),
            )
            posed.append(project(out["smpl_verts"], Pt))  # (F, V, 3)
        posed = torch.stack(posed)  # (P, F, V, 3)
        tri = posed[:, :, body.faces, :2]
        span = int((tri.amax(-2).ceil() - tri.amin(-2).floor()).max()) + 1  # one sync for every face box
        depth = torch.stack([torch.stack([zbuffer(posed[p, f], body.faces, H, W, span) for f in range(F)])
                             for p in range(num_person)])  # (P, F, H, W)
        front = depth.min(0).values
        vis = torch.isfinite(depth) & (depth == front[None])  # (P, F, H, W)
        # the frames: a smooth seeded background and a colour per person, with texture noise
        gen = torch.Generator(device).manual_seed(int(rng.integers(0, 2**62)))
        yy = torch.arange(H, device=device, dtype=torch.float32)[:, None].expand(H, W) / max(H, W)
        xx = torch.arange(W, device=device, dtype=torch.float32)[None, :].expand(H, W) / max(H, W)
        bg0, bg1 = (torch.as_tensor(rng.uniform(0.3, 0.9, 3), dtype=torch.float32, device=device) for _ in range(2))
        mix = (0.5 + 0.5 * torch.sin(3.0 * xx + 2.0 * yy + float(rng.uniform(0, 2 * math.pi))))[..., None]
        img = (bg0 * mix + bg1 * (1 - mix)).expand(F, H, W, 3).clone()
        colors = torch.as_tensor(PERSON_COLORS[:num_person] * rng.uniform(0.8, 1.2, (num_person, 1)),
                                 dtype=torch.float32, device=device)
        shade = (0.85 + 0.15 * yy)[..., None]
        for p in range(num_person):
            img = torch.where(vis[p][..., None], colors[p] * shade, img)
        img = img + 0.02 * torch.randn(img.shape, generator=gen, device=device)
        images = (img * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
        masks = vis.permute(1, 0, 2, 3).cpu().numpy()
    return {"images": images, "masks": masks, "poses": poses, "transl": transl, "betas": betas, "P": P}


def write_sequence(scene: dict, root: str) -> None:
    """The training directory in `Hi4DSequence`'s layout (scale 1: the scale
    matrices are identities). zlib releases the interpreter, so threads write."""
    F, num_person = scene["masks"].shape[:2]
    jobs = [(os.path.join(root, "image", f"{f:04d}.png"), scene["images"][f]) for f in range(F)]
    jobs += [(os.path.join(root, "mask", f"{p}", f"{f:04d}.png"), scene["masks"][f, p].astype(np.uint8) * 255)
             for p in range(num_person) for f in range(F)]
    for d in {os.path.dirname(path) for path, _ in jobs}:
        os.makedirs(d, exist_ok=True)
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda job: write_png(*job), jobs))
    np.save(os.path.join(root, "poses.npy"), scene["poses"])
    np.save(os.path.join(root, "normalize_trans.npy"), scene["transl"])
    np.save(os.path.join(root, "mean_shape.npy"), scene["betas"])
    cams = {}
    for f in range(F):
        cams[f"scale_mat_{f}"] = np.eye(4)
        cams[f"world_mat_{f}"] = scene["P"]
    np.savez(os.path.join(root, "cameras_normalize.npz"), **cams)
