"""Segment Anything (SAM) as `nn.Module`s: the ViT image encoder with windowed
and decomposed relative-position attention, the prompt encoder, the two-way
transformer mask decoder, and the predictor the SAM stage drives.

Counterpart of `multiply_tpu/models/sam.py`. The parameter names are the
official `segment_anything` state-dict keys (`tests/data/sam_manifests/`), so
`build_sam_predictor` loads `sam_vit_h_4b8939.pth` with `load_state_dict(...,
strict=True)`; `random_sam` draws weights from a seed with the JAX package's
initialisers' distributions. Where the JAX package and the official module
differ, this follows the JAX package: every LayerNorm has eps 1e-6 (the
official decoder's have 1e-5), and prompts are padded to `MAX_POINTS` points
of label -1 that carry the `not_a_point` embedding and attend in the decoder.

Everything here is plain PyTorch (matmul, softmax, linear, conv, transposed
conv); nothing of it reaches a hand-written kernel. The image embedding stays
on the device between `set_image` and the `predict` calls that read it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.resize import resize_linear

VIT_CONFIGS = {
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, global_attn=(2, 5, 8, 11)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, global_attn=(5, 11, 17, 23)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, global_attn=(7, 15, 23, 31)),
    # tiny variant for tests (random weights, architecture-only checks)
    "vit_test": dict(embed_dim=32, depth=2, num_heads=2, global_attn=(1,)),
    # vit_b's widths at the real 1024 input, one windowed and one global block
    "vit_b2": dict(embed_dim=768, depth=2, num_heads=12, global_attn=(1,)),
}
IMG_SIZE = 1024
PATCH = 16
PROMPT_DIM = 256
WINDOW = 14
LN_EPS = 1e-6  # flax's LayerNorm default, which the JAX package uses everywhere

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
MAX_POINTS = 64  # prompts padded to a fixed count, as the JAX package does for fixed jit shapes


def window_partition(x: torch.Tensor, w: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, H, W, C) -> (B * windows, w, w, C), zero-padded to multiples of w;
    also returns the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h, pad_w = (w - H % w) % w, (w - W % w) % w
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, C), (Hp, Wp)


def window_unpartition(x: torch.Tensor, w: int, pad_hw: tuple[int, int], hw: tuple[int, int]) -> torch.Tensor:
    """Inverse of `window_partition`: (B * windows, w, w, C) -> (B, H, W, C)."""
    (Hp, Wp), (H, W) = pad_hw, hw
    B = x.shape[0] // (Hp // w * Wp // w)
    x = x.reshape(B, Hp // w, Wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def _resize_rel(rel_pos: torch.Tensor, length: int) -> torch.Tensor:
    """A (L, head_dim) table resized linearly along L (half-pixel centres)."""
    return F.interpolate(rel_pos.T[None], size=length, mode="linear")[0].T


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, head_dim) relative-position embeddings; a table of
    another length than 2 * max(q_size, k_size) - 1 is first resized linearly."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        rel_pos = _resize_rel(rel_pos, max_rel)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    idx = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[idx.long()]


class _MLP(nn.Module):
    """Two linear layers with an activation between (`mlp.lin1`, `mlp.lin2`)."""

    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.lin1, self.lin2, self.act = nn.Linear(dim, hidden), nn.Linear(hidden, dim), act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class ViTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, input_size: tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        B, H, W, C = x.shape
        nh, hd = self.num_heads, C // self.num_heads
        qkv = self.qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (B, nh, HW, hd)
        attn = (q * hd**-0.5) @ k.transpose(-2, -1)
        r_q = q.reshape(B, nh, H, W, hd)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, get_rel_pos(H, H, self.rel_pos_h))
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, get_rel_pos(W, W, self.rel_pos_w))
        # both terms go into the (B, nh, H, W, H, W) view in place: at the 64x64
        # grid a full copy of the logits is 1 GiB
        logits = attn.view(B, nh, H, W, H, W)
        logits.add_(rel_h[..., :, None]).add_(rel_w[..., None, :])
        attn = attn.softmax(-1)
        out = (attn @ v).transpose(1, 2).reshape(B, H * W, C)
        return self.proj(out).reshape(B, H, W, C)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, input_size: tuple[int, int]):
        super().__init__()
        self.window_size = window_size  # 0 = global attention
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ViTAttention(dim, num_heads, (window_size, window_size) if window_size else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _MLP(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        h = self.norm1(x)
        if self.window_size:
            hw = (x.shape[1], x.shape[2])
            h, pad_hw = window_partition(h, self.window_size)
            h = window_unpartition(self.attn(h), self.window_size, pad_hw, hw)
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map."""

    def __init__(self, channels: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.weight[:, None, None] + self.bias[:, None, None]


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)


class ImageEncoderViT(nn.Module):
    def __init__(self, embed_dim: int, depth: int, num_heads: int, global_attn, img_size: int = IMG_SIZE,
                 out_chans: int = PROMPT_DIM):
        super().__init__()
        grid = img_size // PATCH
        self.patch_embed = _PatchEmbed(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, 0 if i in global_attn else WINDOW, (grid, grid)) for i in range(depth)
        )
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False), LayerNorm2d(out_chans),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, S, S, 3) -> (B, S/16, S/16, 256)
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.neck(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_feats))


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = PROMPT_DIM, img_size: int = IMG_SIZE):
        super().__init__()
        self.embed_dim, self.img_size = embed_dim, img_size
        self.pe_layer = _PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2: box top-left, 3: box bottom-right
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, stride=2), LayerNorm2d(4), nn.GELU(),
            nn.Conv2d(4, 16, 2, stride=2), LayerNorm2d(16), nn.GELU(),
            nn.Conv2d(16, embed_dim, 1),
        )

    def _pe(self, coords: torch.Tensor) -> torch.Tensor:
        """Random-Fourier encoding of coordinates in [0, 1], (..., 2) -> (..., C)."""
        c = (2.0 * coords - 1.0) @ self.pe_layer.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def dense_pe(self, grid: int) -> torch.Tensor:
        """(grid, grid, C) encoding of the embedding grid's cell centres."""
        gauss = self.pe_layer.positional_encoding_gaussian_matrix
        xs = (torch.arange(grid, device=gauss.device, dtype=gauss.dtype) + 0.5) / grid
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        return self._pe(torch.stack([gx, gy], dim=-1))

    def forward(self, points: torch.Tensor, labels: torch.Tensor, mask_input: torch.Tensor | None):
        """points (N, 2) in input pixels, labels (N,): 1 positive, 0 negative,
        -1 padding, 2 and 3 box corners; mask_input (4g, 4g) logits or None.
        Returns (sparse (N, C), dense (g, g, C))."""
        pe = self._pe((points + 0.5) / self.img_size)
        lbl = labels[:, None]
        emb = torch.where(lbl == -1, self.not_a_point_embed.weight, pe)
        for i, point_embed in enumerate(self.point_embeddings):
            emb = torch.where(lbl == i, pe + point_embed.weight, emb)
        if mask_input is not None:
            dense = self.mask_downscaling(mask_input[None, None])[0].permute(1, 2, 0)
        else:
            g = self.img_size // PATCH
            dense = self.no_mask_embed.weight[0].expand(g, g, self.embed_dim)
        return emb, dense


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(dim, inner) for _ in range(3))
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:  # (N, dim) each
        def split(x):
            return x.reshape(x.shape[0], self.num_heads, -1).transpose(0, 1)

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        attn = ((qh * qh.shape[-1] ** -0.5) @ kh.transpose(1, 2)).softmax(-1)
        return self.out_proj((attn @ vh).transpose(0, 1).reshape(q.shape[0], -1))


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int = PROMPT_DIM, num_heads: int = 8, mlp_dim: int = 2048, skip_first_pe: bool = False):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = DecoderAttention(dim, num_heads)
        self.cross_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.cross_attn_image_to_token = DecoderAttention(dim, num_heads, 2)
        self.mlp = _MLP(dim, mlp_dim, F.relu)
        self.norm1, self.norm2, self.norm3, self.norm4 = (nn.LayerNorm(dim, eps=LN_EPS) for _ in range(4))

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:  # the first block replaces the queries (no residual)
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class _TwoWayTransformer(nn.Module):
    def __init__(self, dim: int = PROMPT_DIM):
        super().__init__()
        self.layers = nn.ModuleList([TwoWayBlock(dim, skip_first_pe=True), TwoWayBlock(dim)])
        self.final_attn_token_to_image = DecoderAttention(dim, 8, 2)
        self.norm_final_attn = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, tokens, src, pos):
        q, k = tokens, src
        for layer in self.layers:
            q, k = layer(q, k, tokens, pos)
        q = self.norm_final_attn(q + self.final_attn_token_to_image(q + tokens, k + pos, k))
        return q, k


class _HeadMLP(nn.Module):
    """Linear layers with ReLU between them (`.layers.<i>`)."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        dims = [dim] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class MaskDecoder(nn.Module):
    def __init__(self, dim: int = PROMPT_DIM, num_mask_tokens: int = 4):
        super().__init__()
        self.transformer = _TwoWayTransformer(dim)
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(num_mask_tokens, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, stride=2), LayerNorm2d(dim // 4), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2), nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(_HeadMLP(dim, dim, dim // 8) for _ in range(num_mask_tokens))
        self.iou_prediction_head = _HeadMLP(dim, dim, num_mask_tokens)

    def forward(self, image_embed, image_pe, sparse_prompt, dense_prompt):
        """(g, g, C) embedding, its encoding and the dense prompt, (N, C) sparse
        prompt -> (masks (4, 4g, 4g), iou (4,))."""
        g, C = image_embed.shape[0], image_embed.shape[-1]
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight, sparse_prompt], dim=0)
        q, k = self.transformer(tokens, (image_embed + dense_prompt).reshape(-1, C), image_pe.reshape(-1, C))
        up = self.output_upscaling(k.reshape(g, g, C).permute(2, 0, 1)[None])[0]  # (C/8, 4g, 4g)
        hyper = torch.stack([mlp(q[1 + i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)])
        masks = torch.einsum("mc,chw->mhw", hyper, up)
        return masks, self.iou_prediction_head(q[0])


def full_f32() -> None:
    """Products and convolutions in full f32, as the JAX package computes
    them: cuDNN's default would run the patch embedding and the neck in TF32.
    PyTorch's flags are process-wide, so this is too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Sam(nn.Module):
    """Encoder, prompt encoder and decoder; building one sets `full_f32`."""

    def __init__(self, variant: str = "vit_h", img_size: int = IMG_SIZE):
        super().__init__()
        full_f32()
        cfg = VIT_CONFIGS[variant]
        self.img_size = img_size
        self.image_encoder = ImageEncoderViT(cfg["embed_dim"], cfg["depth"], cfg["num_heads"], cfg["global_attn"],
                                             img_size=img_size)
        self.prompt_encoder = PromptEncoder(img_size=img_size)
        self.mask_decoder = MaskDecoder()

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(x)

    def decode(self, image_embed, points, labels, mask_input):
        sparse, dense = self.prompt_encoder(points, labels, mask_input)
        return self.mask_decoder(image_embed, self.prompt_encoder.dense_pe(image_embed.shape[0]), sparse, dense)


# ---------------------------------------------------------------------------
# weights: a seeded initialiser and the official checkpoint
# ---------------------------------------------------------------------------


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: truncated normal (2 std) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def init_sam_weights_(model: Sam, generator: torch.Generator) -> Sam:
    """Draw every weight as the JAX package's initialisers do: kernels LeCun
    normal, biases zero, norms one and zero, tokens and embeddings and the
    Fourier matrix N(0, 1), `pos_embed` and the rel-pos tables zero."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
        elif isinstance(module, nn.ConvTranspose2d):  # weight (in, out, kh, kw)
            w = module.weight
            _lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
        elif isinstance(module, nn.Conv2d):  # weight (out, in, kh, kw)
            _lecun_normal_(module.weight, module.weight[0].numel(), generator)
        elif isinstance(module, (nn.LayerNorm, LayerNorm2d)):
            module.weight.fill_(1.0)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0, generator=generator)
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.LayerNorm, LayerNorm2d)) \
                and module.bias is not None:
            module.bias.zero_()
    model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(0.0, 1.0, generator=generator)
    model.image_encoder.pos_embed.zero_()
    for block in model.image_encoder.blocks:
        block.attn.rel_pos_h.zero_()
        block.attn.rel_pos_w.zero_()
    return model


def random_sam(variant: str, generator: torch.Generator, device="cuda", img_size: int = IMG_SIZE) -> Sam:
    """A `Sam` with seeded random weights, built on `device` without a first
    default initialisation."""
    with torch.device("meta"):
        model = Sam(variant, img_size)
    return init_sam_weights_(model.to_empty(device=device), generator).eval()


def load_sam(path: str, variant: str = "vit_h", device="cuda") -> Sam:
    """An official `segment_anything` checkpoint, loaded strictly: a key left
    over or missing raises. A rel-pos table of another length (a model
    fine-tuned at another input size) is resized once here, as `get_rel_pos`
    would resize it at every call."""
    state = torch.load(path, map_location=device, weights_only=True)
    with torch.device("meta"):
        model = Sam(variant)
    for name, p in model.named_parameters():
        if name.endswith(("rel_pos_h", "rel_pos_w")) and name in state and state[name].shape != p.shape:
            state[name] = _resize_rel(state[name], p.shape[0]).contiguous()
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()


# ---------------------------------------------------------------------------
# the predictor the SAM stage drives
# ---------------------------------------------------------------------------


class SamPredictor:
    """`set_image` once per frame, then `predict` as often as the prompts ask;
    low-resolution logits chain back in as `mask_input_logits`. Its state (the
    embedding, the scale, the frame's size) belongs to the one caller that
    drives it: the SAM stage, on whichever thread runs it."""

    def __init__(self, model: Sam):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self._mean = torch.as_tensor(PIXEL_MEAN, device=self.device)
        self._std = torch.as_tensor(PIXEL_STD, device=self.device)
        self._embed: torch.Tensor | None = None
        self._scale = 1.0
        self._orig_hw: tuple[int, int] | None = None

    @torch.inference_mode()
    def preprocess(self, rgb_uint8: np.ndarray) -> torch.Tensor:
        """The encoder's input (1, S, S, 3) for a uint8 RGB frame: its long
        side resized to S, normalised, zero-padded at the bottom and right."""
        S = self.model.img_size
        H, W = rgb_uint8.shape[:2]
        scale = S / max(H, W)
        nh, nw = int(round(H * scale)), int(round(W * scale))
        img = resize_linear(torch.as_tensor(np.ascontiguousarray(rgb_uint8), device=self.device), (nw, nh))
        padded = torch.zeros((1, S, S, 3), device=self.device)
        padded[0, :nh, :nw] = (img.float() - self._mean) / self._std
        return padded

    @torch.inference_mode()
    def set_image(self, rgb_uint8: np.ndarray) -> None:
        """Encode one frame and keep its embedding on the device."""
        H, W = rgb_uint8.shape[:2]
        self._orig_hw = (H, W)
        self._scale = self.model.img_size / max(H, W)
        self._embed = self.model.encode_image(self.preprocess(rgb_uint8))[0]

    @torch.inference_mode()
    def predict(self, point_coords, point_labels, box=None, mask_input_logits=None) -> np.ndarray:
        """(256, 256) low-resolution logits of the first mask token. The box
        corners go after the points, so past `MAX_POINTS` they are dropped."""
        pts = np.asarray(point_coords, np.float32) * self._scale
        lbl = np.asarray(point_labels, np.int32)
        if box is not None:
            corners = np.asarray(box, np.float32).reshape(2, 2) * self._scale
            pts = np.concatenate([pts, corners], axis=0)
            lbl = np.concatenate([lbl, np.asarray([2, 3], np.int32)])
        pts, lbl = pts[:MAX_POINTS], lbl[:MAX_POINTS]
        pad = MAX_POINTS - len(pts)
        pts = np.pad(pts, ((0, pad), (0, 0)))
        lbl = np.pad(lbl, (0, pad), constant_values=-1)

        m = None
        if mask_input_logits is not None:
            m = torch.as_tensor(np.asarray(mask_input_logits, np.float32), device=self.device)
            want = (self.model.img_size // PATCH) * 4
            if tuple(m.shape) != (want, want):
                m = resize_linear(m, (want, want))
        masks, _ = self.model.decode(self._embed, torch.as_tensor(pts, device=self.device),
                                     torch.as_tensor(lbl, device=self.device), m)
        return masks[0].cpu().numpy()

    @torch.inference_mode()
    def logits_to_full_res(self, low_res_logits: np.ndarray) -> np.ndarray:
        """Low-resolution logits -> the frame's (H, W): up to the input square,
        crop the frame's part, resize to the frame."""
        S = self.model.img_size
        H, W = self._orig_hw
        up = resize_linear(torch.as_tensor(np.asarray(low_res_logits, np.float32), device=self.device), (S, S))
        nh, nw = int(round(H * self._scale)), int(round(W * self._scale))
        return resize_linear(up[:nh, :nw], (W, H)).cpu().numpy()


def build_sam_predictor(checkpoint_path: str, variant: str = "vit_h", device="cuda") -> SamPredictor:
    return SamPredictor(load_sam(checkpoint_path, variant, device))
