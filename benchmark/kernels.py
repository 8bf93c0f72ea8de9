"""The yardstick's arithmetic: each hand-written kernel's least time from the
shapes of its calls, and the model FLOPs of one training step from the
configuration. A least time is the larger of the operations over the
card's peak rate and the bytes over its bandwidth, each input byte read once
and each output byte written once (`peaks.json`).

The step's FLOPs count every model option that the renderer builds: the
conditioning of the SDF net (`cond`, the shared net's identity latents), the
tri-plane or its pyramid with the adapter, the offset head, the beta encoder
and the five rendering modes. The widths come from the reference's own
modules (`reference/networks.py`, `reference/renderer.py`).
"""

from __future__ import annotations

import json
import os

from .reference.networks import COND_DIMS
from .reference.renderer import ID_LATENT, N_EIKONAL, N_ZERO_POSE

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")
NN1_OPS_PER_PAIR = 9  # 3 differences, 3 products, 2 sums and 1 comparison per (query, reference) pair
GRID_OPS_PER_POINT = 30  # cell index and fractions (12), 7 lerps of 3 (21) less the shared loads: ~30
LOOKUP_MACS = 4  # a bilinear lookup: 4 multiply-adds a channel, plane and level
POSE_DIM = COND_DIMS["smpl"]  # the body pose's 69 conditioning dims
COND_EMBED = 8  # the rendering net's pose (and identity) embedding width
TRIPLANE_RES = (128, 64, 32, 16)  # the pyramid's levels where `triplane_res` is not given
ADAPTER_WIDTH = 256  # the pyramid's adapter MLP: 3 C L -> 256 -> 256 -> C + 1
OFFSET_WIDTH = 256  # the offset head: 4 layers of 256, then 1 + F
BETA_DIM = 10  # the beta encoder's input, per person and call


def peaks(kind: str) -> dict | None:
    with open(PEAKS_FILE) as f:
        return json.load(f).get(kind)


def nn1_bound(P: int, N: int, V: int, peak: dict) -> tuple[float, str]:
    """(seconds, "operations" | "bytes") of nn1 on (P, N, 3) queries against (P, V, 3)."""
    ops = NN1_OPS_PER_PAIR * P * N * V
    nbytes = 4 * (P * N * 3 + P * V * 3) + P * N * (4 + 8)  # points in; d2 (f32) and idx (i64) out
    t_ops, t_bytes = ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def grid_bound(P: int, N: int, res: int, group: int, peak: dict) -> tuple[float, str]:
    """(seconds, bound) of the trilinear lookup of (P, N, 3) points in (P, res^3)
    grids, reduced to the least value of each run of `group` points."""
    ops = GRID_OPS_PER_POINT * P * N
    nbytes = 4 * (P * res**3 + P * N * 3 + P * 6) + 4 * P * (N // group)
    t_ops, t_bytes = ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def triplane_bound(P: int, N: int, features: int, resolutions, peak: dict) -> tuple[float, str]:
    """(seconds, bound) of the tri-plane pyramid's lookups: (P, N, 3) points in
    P persons' planes of `features` channels at each of `resolutions`, the
    3 L C features of each point written out; the planes and the points read
    once, LOOKUP_MACS multiply-adds a channel, plane and level."""
    levels = len(resolutions)
    ops = 2 * LOOKUP_MACS * features * 3 * levels * P * N
    nbytes = 4 * (P * 3 * features * sum(r * r for r in resolutions) + P * N * 3 + P * N * 3 * levels * features)
    t_ops, t_bytes = ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def embed_dim(multires: int, d: int) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def implicit_macs(net: dict, cond_dim: int) -> int:
    """Multiply-adds a point of one implicit MLP (skip connections and conditioning as built)."""
    in0 = embed_dim(int(net["multires"]), int(net["d_in"]))
    dims = [in0] + list(net["dims"]) + [int(net["d_out"]) + int(net["feature_vector_size"])]
    skip = set(net.get("skip_in", []))
    macs, h = 0, in0
    for layer in range(len(dims) - 1):
        out = dims[layer + 1] - (in0 if layer + 1 in skip else 0)
        if layer == 0:
            h += cond_dim
        if layer in skip:
            h += in0
        macs += h * out
        h = out
    return macs


def foreground_point_macs(model: dict) -> int:
    """Multiply-adds a point of one foreground SDF evaluation: all that the
    renderer's `_implicit` runs per point. The SDF net at its conditioning
    width (pose + identity latent under `use_person_encoder`, whatever `cond`
    says), the tri-plane lookups (one level, or the pyramid's levels and its
    adapter) and the offset head. The beta encoder runs once a person and
    call (`beta_macs`)."""
    imp = model["implicit_network"]
    cond = imp["cond"]
    if cond not in COND_DIMS:
        raise ValueError(f"implicit_network.cond {cond!r}: not one of {sorted(COND_DIMS)}")
    cond_dim = POSE_DIM + ID_LATENT if model.get("use_person_encoder", False) else COND_DIMS[cond]
    macs = implicit_macs(imp, cond_dim)
    if cond == "smpl_tri":
        if imp.get("multi_triplane", False):
            levels = len(imp.get("triplane_res", TRIPLANE_RES))
            dims = [3 * ID_LATENT * levels, ADAPTER_WIDTH, ADAPTER_WIDTH, ID_LATENT + 1]
            macs += sum(i * o for i, o in zip(dims[:-1], dims[1:]))
        else:
            levels = 1
        macs += LOOKUP_MACS * ID_LATENT * 3 * levels
    if imp.get("offset_head", False):
        feat = int(imp["feature_vector_size"])
        in_dim = 1 + feat + cond_dim + embed_dim(int(imp["multires"]), int(imp["d_in"]))
        macs += in_dim * OFFSET_WIDTH + 3 * OFFSET_WIDTH * OFFSET_WIDTH + OFFSET_WIDTH * (feat + 1)
    return macs


def beta_macs(model: dict) -> int:
    """Multiply-adds of the beta encoder a person and call (0 without one)."""
    imp = model["implicit_network"]
    return BETA_DIM * int(imp["dims"][0]) if imp.get("beta_encoding", False) else 0


def rendering_macs(net: dict, dim_frame: int) -> int:
    """Multiply-adds a point of a rendering net in any of its five modes; the
    pose and identity embeddings (once a person and call) are not counted."""
    pe = embed_dim(int(net.get("multires_view", -1)), 3)
    feat = int(net["feature_vector_size"])
    widths = {
        "idr": 3 + pe + 3 + feat,  # points, view directions, normals, features
        "nerf_frame_encoding": pe + dim_frame + feat,  # view directions, frame latent, features
        "pose_no_view": pe + 3 + COND_EMBED + feat,  # points, normals, pose embedding, features
        "pose_id_no_view": 3 + 3 + 2 * COND_EMBED + feat,  # points, normals, pose and identity embeddings
        "nerf": 3 + feat,  # view directions, features
    }
    mode = net["mode"]
    if mode not in widths:
        raise ValueError(f"rendering mode {mode!r}: not one of {sorted(widths)}")
    h, macs = widths[mode], 0
    for out in list(net["dims"]) + [int(net["d_out"])]:
        macs += h * out
        h = out
    return macs


def cond_width(net: dict, dim_frame: int) -> int:
    """The conditioning width of a network built from `net` alone (the background's)."""
    cond = net["cond"]
    if cond == "frame":
        return dim_frame
    if cond not in COND_DIMS:
        raise ValueError(f"bg_implicit_network.cond {cond!r}: not one of {sorted(COND_DIMS)}")
    return COND_DIMS[cond]


def step_flops(model: dict, persons: int, rays: int, body_verts: int) -> dict:
    """Model FLOPs of one training step, term by term (2 per multiply-add;
    the deformer's nearest-vertex search at NN1_OPS_PER_PAIR a pair). A backward
    pass counts twice its forward; the render points' normals (a VJP) once.
    Each foreground SDF evaluation costs `foreground_point_macs` a point, and
    the beta encoder's `beta_macs` a person and call, under the same factors:
    x1 in the sampler's calls, x6 at the render points and the eikonal points
    (forward, normals VJP, backward of both), x3 (forward and backward) in
    the SMPL-surface and zero-pose terms where their weights are on."""
    s = model["ray_sampler"]
    imp = 2 * foreground_point_macs(model)
    beta = 2 * persons * beta_macs(model)
    dim_frame = int(model.get("dim_frame_encoding", 32))
    rend = 2 * rendering_macs(model["rendering_network"], dim_frame)
    bg_net = model["bg_implicit_network"]
    bg = 2 * implicit_macs(bg_net, cond_width(bg_net, dim_frame))
    bg_rend = 2 * rendering_macs(model["bg_rendering_network"], dim_frame)
    knn = NN1_OPS_PER_PAIR * body_verts
    iters = int(s["max_total_iters"])
    sampler_pts = persons * rays * (int(s["N_samples_eval"]) * iters + 1)
    render_pts = persons * rays * (int(s["N_samples"]) + int(s["N_samples_extra"]) + 1)
    bg_pts = rays * int(s["N_samples_inverse_sphere"])
    loss = model.get("loss") or {}
    surface = float(loss.get("smpl_surface_weight", 0)) > 0
    zero_pose = float(loss.get("zero_pose_weight", 0)) > 0
    terms = {
        "sampler": sampler_pts * (imp + knn),
        "render_implicit": render_pts * (6 * imp + knn),  # forward, normals VJP, backward of both (4x)
        "render_color": render_pts * 3 * rend,
        "background": bg_pts * 3 * (bg + bg_rend),
        "eikonal": persons * N_EIKONAL * 6 * imp,
        "smpl_surface": persons * rays * (3 * imp + knn) if surface else 0,
        "zero_pose": 2 * persons * N_ZERO_POSE * 3 * imp if zero_pose else 0,
        # the sampler's iters + 1 calls, the render and eikonal calls, the two terms' calls
        "beta_encoder": beta * ((iters + 1) + 6 + 6 + (3 if surface else 0) + (6 if zero_pose else 0)),
    }
    terms["total"] = sum(terms.values())
    return terms
