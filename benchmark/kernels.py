"""The yardstick's arithmetic: each hand-written kernel's least time from the
shapes of its calls, and the model FLOPs of one training step from the
configuration. A least time is the larger of the operations over the
card's peak rate and the bytes over its bandwidth, each input byte read once
and each output byte written once (`peaks.json`).
"""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")
NN1_OPS_PER_PAIR = 9  # 3 differences, 3 products, 2 sums and 1 comparison per (query, reference) pair
GRID_OPS_PER_POINT = 30  # cell index and fractions (12), 7 lerps of 3 (21) less the shared loads: ~30
COND_DIMS = {"smpl": 69, "frame": 32, "smpl_id": 133, "none": 0}
EIKONAL_POINTS = 512  # a person's eikonal samples a step (the renderer's N_EIKONAL)
COND_EMBED = 8  # the rendering net's pose embedding width


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


def rendering_macs(net: dict, dim_frame: int) -> int:
    pe = embed_dim(int(net.get("multires_view", -1)), 3)
    mode = net["mode"]
    if mode == "pose_no_view":
        h = pe + 3 + COND_EMBED + int(net["feature_vector_size"])
    elif mode == "nerf_frame_encoding":
        h = pe + dim_frame + int(net["feature_vector_size"])
    else:
        raise NotImplementedError(f"rendering mode {mode!r}")
    macs = 0
    for out in list(net["dims"]) + [int(net["d_out"])]:
        macs += h * out
        h = out
    return macs


def step_flops(model: dict, persons: int, rays: int, body_verts: int) -> dict:
    """Model FLOPs of one training step, term by term (2 per multiply-add;
    the deformer's nearest-vertex search at NN1_OPS_PER_PAIR a pair). A backward
    pass counts twice its forward; the render points' normals (a VJP) once."""
    s = model["ray_sampler"]
    imp = 2 * implicit_macs(model["implicit_network"], COND_DIMS[model["implicit_network"]["cond"]])
    dim_frame = int(model.get("dim_frame_encoding", 32))
    rend = 2 * rendering_macs(model["rendering_network"], dim_frame)
    bg_net = model["bg_implicit_network"]
    bg = 2 * implicit_macs(bg_net, dim_frame if bg_net["cond"] == "frame" else COND_DIMS[bg_net["cond"]])
    bg_rend = 2 * rendering_macs(model["bg_rendering_network"], dim_frame)
    knn = NN1_OPS_PER_PAIR * body_verts
    sampler_pts = persons * rays * (int(s["N_samples_eval"]) * int(s["max_total_iters"]) + 1)
    render_pts = persons * rays * (int(s["N_samples"]) + int(s["N_samples_extra"]) + 1)
    bg_pts = rays * int(s["N_samples_inverse_sphere"])
    terms = {
        "sampler": sampler_pts * (imp + knn),
        "render_implicit": render_pts * (6 * imp + knn),  # forward, normals VJP, backward of both (4x)
        "render_color": render_pts * 3 * rend,
        "background": bg_pts * 3 * (bg + bg_rend),
        "eikonal": persons * EIKONAL_POINTS * 6 * imp,
    }
    terms["total"] = sum(terms.values())
    return terms
