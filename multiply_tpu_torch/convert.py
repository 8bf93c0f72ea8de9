"""Carry weights and state across from the JAX package.

Input is the JAX package's parameter pytree and per-person state with every
leaf already turned into a numpy array (nested dicts and NamedTuples; this
module imports nothing of JAX). flax kernels are (in, out) with weight-norm
`g` per output; the port's weights are (out, in), so kernels are transposed.

Port parameter names map to pytree paths as
  net.<net>.lins.<l>.{weight,bias,g}   -> net/<net>/params/lin<l>/{kernel,bias,g}
  net.fg_render.{lin_pose,lin_id}.*    -> net/fg_render/params/{lin_pose,lin_id}/*
  net.offset_head.heads.<i>.*, .last.* -> net/offset_head/params/head<i>/*, .../last/*
  net.beta_encoder.beta_layer.*        -> net/beta_encoder/params/beta_layer/*
  net.triplane.planes, .planes_<r>     -> net/triplane/params/planes, .../planes_<r>
  net.triplane.dense.<i>.*             -> net/triplane/params/Dense_<i>/*
  net.frame_latent, net.beta, net.person_latent -> net/<the same name>
  body.<field>                         -> body/<field>
A shared shape net (`use_person_encoder`) has no person axis on either side.
Adam moments map like their parameters (`train_state_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from .body.server import SMPLServer
from .body.smpl import BodyModel
from .engine.optim import AdamState
from .models.deformer import SMPLDeformer
from .models.renderer import PersonState


def flax_path(name: str) -> tuple[tuple[str, ...], bool]:
    """(pytree path, whether the leaf is a transposed kernel) of a port parameter."""
    parts = name.split(".")
    if parts[0] == "body" or len(parts) == 2:
        return tuple(parts), False
    _, net, *layer, leaf = parts
    if not layer:  # a bare parameter of a module: the tri-plane's planes
        return ("net", net, "params", leaf), False
    layer = _LAYER_LISTS[layer[0]] + layer[1] if layer[0] in _LAYER_LISTS else layer[0]
    return ("net", net, "params", layer, "kernel" if leaf == "weight" else leaf), leaf == "weight"


_LAYER_LISTS = {"lins": "lin", "heads": "head", "dense": "Dense_"}


def flax_leaf_paths(tree, prefix=()) -> set[tuple[str, ...]]:
    """Paths of every leaf in a pytree of nested dicts and NamedTuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    else:
        return {prefix}
    return set().union(*(flax_leaf_paths(v, prefix + (k,)) for k, v in items))


def flax_leaf(tree, name: str) -> np.ndarray:
    """The pytree leaf (numpy, pytree layout) that port parameter `name` maps to."""
    for key in flax_path(name)[0]:
        tree = tree[key] if isinstance(tree, dict) else getattr(tree, key)
    return np.asarray(tree)


def to_flax_layout(name: str, value) -> np.ndarray:
    """A port parameter (or its gradient) in the layout of its pytree leaf."""
    value = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
    return np.swapaxes(value, -1, -2) if flax_path(name)[1] else value


def load_params(params: dict, tree) -> None:
    """Copy the pytree's leaves into the port's named parameters, in place.
    Given the whole {"net", "body"} pytree, a leaf that no parameter takes, or
    a parameter with no leaf, raises."""
    if isinstance(tree, dict) and set(tree) == {"net", "body"}:
        want, have = {flax_path(n)[0] for n in params}, flax_leaf_paths(tree)
        if want != have:
            raise ValueError(f"pytree leaves left over {sorted(have - want)}, missing {sorted(want - have)}")
    with torch.no_grad():
        for name, p in params.items():
            value = flax_leaf(tree, name)
            if flax_path(name)[1]:
                value = np.swapaxes(value, -1, -2)
            if value.shape != tuple(p.shape):
                raise ValueError(f"{name}: pytree leaf {value.shape} vs parameter {tuple(p.shape)}")
            p.copy_(torch.tensor(np.array(value), dtype=p.dtype))


def _t(x, device, dtype=torch.float32):
    return torch.tensor(np.array(x), dtype=dtype, device=device)


def body_model_from_jax(model, device="cuda") -> BodyModel:
    return BodyModel(
        *(
            _t(getattr(model, f), device, torch.int64 if f in ("faces", "extra_joint_idxs") else torch.float32)
            for f in BodyModel._fields
        )
    )


def server_from_jax(server, device="cuda") -> SMPLServer:
    return SMPLServer(
        body_model_from_jax(server.model, device),
        *(_t(getattr(server, f), device) for f in SMPLServer._fields[1:]),
    )


def person_state_from_jax(state, device="cuda") -> PersonState:
    """A stacked JAX PersonState (numpy leaves) -> the port's PersonState."""
    return PersonState(
        server=server_from_jax(state.server, device),
        deformer=SMPLDeformer(*(_t(x, device) for x in state.deformer)),
        cano_grid={k: _t(v, device) for k, v in state.cano_grid.items()},
        surface_sample_logits=_t(state.surface_sample_logits, device),
    )


def train_state_from_jax(ts, jax_ts) -> None:
    """Carry a whole JAX `TrainState` (numpy leaves) into the port's `ts`, in
    place: the parameters, both Adam states (moments and per-leaf step
    counts) and the epoch, so that a JAX run resumes in the port."""
    params = ts.params()
    load_params(params, jax_ts.params)

    def adam(state, names, wrap):
        mu, nu, count = {}, {}, {}
        for name in names:
            p = params[name]
            for out, tree in ((mu, state.mu), (nu, state.nu)):
                value = flax_leaf(wrap(tree), name)
                if flax_path(name)[1]:
                    value = np.swapaxes(value, -1, -2)
                out[name] = torch.tensor(np.array(value), dtype=p.dtype, device=p.device)
            count[name] = int(flax_leaf(wrap(state.count), name))
        return AdamState(mu, nu, count)

    ts.opt_joint = adam(jax_ts.opt_joint, list(params), lambda t: t)
    ts.opt_pose = adam(jax_ts.opt_pose, [k for k in params if k.startswith("body.")], lambda t: {"body": t})
    ts.epoch = int(jax_ts.epoch)


def sam_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's SAM parameters (`{"params": ...}` or its inner tree,
    numpy leaves) -> an official `segment_anything` state dict: the inverse of
    `multiply_tpu/models/sam.py::port_torch_checkpoint`. Dense kernels are
    transposed, conv kernels go HWIO -> OIHW, and the transposed convs'
    kernels are flipped back spatially and go (kh, kw, in, out) -> (in, out,
    kh, kw). A leaf that no key takes raises."""
    tree = params.get("params", params)
    used: set = set()

    def leaf(*path):
        used.add(path)
        node = tree
        for k in path:
            node = node[k]
        return np.asarray(node)

    def lin(*path):
        return {"weight": leaf(*path, "kernel").T, "bias": leaf(*path, "bias")}

    def conv(*path, bias=True):
        out = {"weight": leaf(*path, "kernel").transpose(3, 2, 0, 1)}
        return out | ({"bias": leaf(*path, "bias")} if bias else {})

    def conv_t(*path):
        return {"weight": leaf(*path, "kernel")[::-1, ::-1].transpose(2, 3, 0, 1), "bias": leaf(*path, "bias")}

    def norm(*path, scale="scale"):
        return {"weight": leaf(*path, scale), "bias": leaf(*path, "bias")}

    def attn(*path):
        return {f"{p}.{k}": v for p in ("q_proj", "k_proj", "v_proj", "out_proj") for k, v in lin(*path, p).items()}

    sd: dict = {}

    def put(prefix, entries):
        sd.update({f"{prefix}.{k}": v for k, v in entries.items()})

    enc = ("image_encoder",)
    put("image_encoder.patch_embed.proj", conv(*enc, "patch_embed"))
    sd["image_encoder.pos_embed"] = leaf(*enc, "pos_embed")
    depth = sum(1 for k in tree["image_encoder"] if k.startswith("block"))
    for i in range(depth):
        pre, blk = f"image_encoder.blocks.{i}", (*enc, f"block{i}")
        put(f"{pre}.norm1", norm(*blk, "norm1"))
        put(f"{pre}.norm2", norm(*blk, "norm2"))
        put(f"{pre}.attn.qkv", lin(*blk, "attn", "qkv"))
        put(f"{pre}.attn.proj", lin(*blk, "attn", "proj"))
        sd[f"{pre}.attn.rel_pos_h"] = leaf(*blk, "attn", "rel_pos_h")
        sd[f"{pre}.attn.rel_pos_w"] = leaf(*blk, "attn", "rel_pos_w")
        put(f"{pre}.mlp.lin1", lin(*blk, "mlp_lin1"))
        put(f"{pre}.mlp.lin2", lin(*blk, "mlp_lin2"))
    put("image_encoder.neck.0", conv(*enc, "neck_conv1", bias=False))
    put("image_encoder.neck.1", norm(*enc, "neck_ln1", scale="weight"))
    put("image_encoder.neck.2", conv(*enc, "neck_conv2", bias=False))
    put("image_encoder.neck.3", norm(*enc, "neck_ln2", scale="weight"))

    pe = ("prompt_encoder",)
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = leaf(*pe, "pe_gaussian")
    points = leaf(*pe, "point_embeddings")
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = points[i][None]
    sd["prompt_encoder.not_a_point_embed.weight"] = leaf(*pe, "not_a_point")[None]
    sd["prompt_encoder.no_mask_embed.weight"] = leaf(*pe, "no_mask")[None]
    for idx, name in ((0, "mask_conv1"), (3, "mask_conv2"), (6, "mask_conv3")):
        put(f"prompt_encoder.mask_downscaling.{idx}", conv(*pe, name))
    for idx, name in ((1, "mask_ln1"), (4, "mask_ln2")):
        put(f"prompt_encoder.mask_downscaling.{idx}", norm(*pe, name, scale="weight"))

    md = ("mask_decoder",)
    sd["mask_decoder.iou_token.weight"] = leaf(*md, "iou_token")
    sd["mask_decoder.mask_tokens.weight"] = leaf(*md, "mask_tokens")
    for i in range(2):
        pre, blk = f"mask_decoder.transformer.layers.{i}", (*md, f"block{i}")
        for official, ours in (("self_attn", "self_attn"), ("cross_attn_token_to_image", "cross_t2i"),
                               ("cross_attn_image_to_token", "cross_i2t")):
            put(f"{pre}.{official}", attn(*blk, ours))
        for n in range(1, 5):
            put(f"{pre}.norm{n}", norm(*blk, f"norm{n}"))
        put(f"{pre}.mlp.lin1", lin(*blk, "mlp_lin1"))
        put(f"{pre}.mlp.lin2", lin(*blk, "mlp_lin2"))
    put("mask_decoder.transformer.final_attn_token_to_image", attn(*md, "final_t2i"))
    put("mask_decoder.transformer.norm_final_attn", norm(*md, "final_norm"))
    put("mask_decoder.output_upscaling.0", conv_t(*md, "upscale_conv1"))
    put("mask_decoder.output_upscaling.1", norm(*md, "upscale_ln", scale="weight"))
    put("mask_decoder.output_upscaling.3", conv_t(*md, "upscale_conv2"))
    for i in range(4):
        for j in range(3):
            put(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}", lin(*md, f"hyper{i}_lin{j}"))
    for j in range(3):
        put(f"mask_decoder.iou_prediction_head.layers.{j}", lin(*md, f"iou_lin{j}"))

    left = flax_leaf_paths(tree) - used
    if left:
        raise ValueError(f"SAM parameters left over: {sorted(left)[:8]}")
    return {k: torch.tensor(np.array(v)) for k, v in sd.items()}
