"""ViTPose: a plain ViT over a person crop and a heatmap head, one map per keypoint.

Counterpart of the model that the JAX package takes from `transformers`
(`VitPoseForPoseEstimation`, with its backbone `VitPoseBackbone`), written
from what those modules compute. The modules and their parameters carry
`transformers`' names, so a `from_pretrained` directory's weights load with
`load_state_dict(strict=True)`.

- Patch embedding: a convolution with the patch size as kernel and stride and
  padding 2, so a 256x192 crop gives 16x12 tokens; the position embedding's
  first row (a class token that ViTPose never uses) is added to every token.
- Encoder: pre-LayerNorm layers, attention with separate q/k/v projections
  (softmax of the scaled products in f32), an erf-GELU MLP of ratio
  `mlp_ratio`.
- Feature map: the final LayerNorm of the hidden state of the last selected
  stage (`out_indices`; stage 0 is the embeddings), as (B, C, H/ph, W/pw).
- Heads: the simple decoder (ReLU, bilinear upsampling by `scale_factor`,
  3x3 conv) or the classic one (two stride-2 transposed convolutions, each
  with eval-mode BatchNorm and ReLU, then a 1x1 conv).

ViTPose+ (`num_experts` > 1) needs a dataset index that the detector never
passes; the model refuses it as `transformers`' forward does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .sam import full_f32

def _pair(x) -> tuple[int, int]:
    return (int(x), int(x)) if isinstance(x, (int, float)) else (int(x[0]), int(x[1]))


@dataclasses.dataclass(frozen=True)
class VitPoseConfig:
    """The settings of `config.json` that the network reads."""

    image_size: tuple[int, int] = (256, 192)
    patch_size: tuple[int, int] = (16, 16)
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    qkv_bias: bool = True
    num_experts: int = 1
    out_index: int = 12  # the stage whose hidden state becomes the feature map
    use_simple_decoder: bool = True
    scale_factor: int = 4
    num_labels: int = 17

    @classmethod
    def from_dict(cls, d: dict) -> "VitPoseConfig":
        """From the dict that a `VitPoseForPoseEstimation` directory's
        `config.json` holds (backbone settings under `backbone_config`)."""
        bb = d.get("backbone_config") or {}
        layers = int(bb.get("num_hidden_layers", 12))
        stages = ["stem"] + [f"stage{i}" for i in range(1, layers + 1)]
        if bb.get("out_indices"):
            out_index = int(bb["out_indices"][-1]) % (layers + 1)
        elif bb.get("out_features"):
            out_index = stages.index(bb["out_features"][-1])
        else:
            out_index = layers
        num_labels = len(d["id2label"]) if d.get("id2label") else int(d.get("num_labels", 2))
        return cls(
            image_size=_pair(bb.get("image_size", (256, 192))), patch_size=_pair(bb.get("patch_size", (16, 16))),
            num_channels=int(bb.get("num_channels", 3)), hidden_size=int(bb.get("hidden_size", 768)),
            num_hidden_layers=layers, num_attention_heads=int(bb.get("num_attention_heads", 12)),
            mlp_ratio=bb.get("mlp_ratio", 4), hidden_act=bb.get("hidden_act", "gelu"),
            layer_norm_eps=float(bb.get("layer_norm_eps", 1e-12)), qkv_bias=bool(bb.get("qkv_bias", True)),
            num_experts=int(bb.get("num_experts", 1)), out_index=out_index, use_simple_decoder=bool(d.get("use_simple_decoder", True)),
            scale_factor=int(d.get("scale_factor", 4)), num_labels=num_labels,
        )

    @property
    def grid(self) -> tuple[int, int]:
        """Tokens down and across."""
        (h, w), (ph, pw) = self.image_size, self.patch_size
        return h // ph, w // pw


class PatchEmbeddings(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.image_size = cfg.image_size
        self.projection = nn.Conv2d(cfg.num_channels, cfg.hidden_size, kernel_size=cfg.patch_size,
                                    stride=cfg.patch_size, padding=2)

    def forward(self, x):
        if tuple(x.shape[-2:]) != self.image_size:
            raise ValueError(f"input of {tuple(x.shape[-2:])} pixels, the model takes {self.image_size}")
        return self.projection(x).flatten(2).transpose(1, 2)


class Embeddings(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.patch_embeddings = PatchEmbeddings(cfg)
        gh, gw = cfg.grid
        self.position_embeddings = nn.Parameter(torch.zeros(1, gh * gw + 1, cfg.hidden_size))

    def forward(self, x):
        pos = self.position_embeddings
        return self.patch_embeddings(x) + pos[:, 1:] + pos[:, :1]


class SelfAttention(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError(f"hidden size {cfg.hidden_size} is not a multiple of {cfg.num_attention_heads} heads")
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=cfg.qkv_bias)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=cfg.qkv_bias)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=cfg.qkv_bias)

    def forward(self, x):
        B, N, C = x.shape

        def split(t):
            return t.view(B, N, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.head_dim ** -0.5, dim=-1, dtype=torch.float32)
        return (attn.to(q.dtype) @ v).transpose(1, 2).reshape(B, N, C)


class SelfOutput(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        return self.dense(x)


class Attention(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.output = SelfOutput(cfg)

    def forward(self, x):
        return self.output(self.attention(x))


class MLP(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        if cfg.hidden_act != "gelu":
            raise ValueError(f"hidden_act {cfg.hidden_act!r}: the port takes ViTPose's 'gelu' (erf) only")
        hidden = int(cfg.hidden_size * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Layer(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.mlp = MLP(cfg)
        self.layernorm_before = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.attention(self.layernorm_before(x))
        return x + self.mlp(self.layernorm_after(x))


class Encoder(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_hidden_layers))


class Backbone(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.out_index = cfg.out_index
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        """The normalised hidden state of stage `out_index`, (B, N, C); later
        layers do not change it and are not run."""
        h = self.embeddings(x)
        for layer in self.encoder.layer[:self.out_index]:
            h = layer(h)
        return self.layernorm(h)


class SimpleDecoder(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.scale_factor = cfg.scale_factor
        self.conv = nn.Conv2d(cfg.hidden_size, cfg.num_labels, kernel_size=3, stride=1, padding=1)

    def forward(self, x):
        x = F.interpolate(F.relu(x), scale_factor=self.scale_factor, mode="bilinear", align_corners=False)
        return self.conv(x)


class ClassicDecoder(nn.Module):
    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        self.deconv1 = nn.ConvTranspose2d(cfg.hidden_size, 256, kernel_size=4, stride=2, padding=1, bias=False)
        self.batchnorm1 = nn.BatchNorm2d(256)
        self.deconv2 = nn.ConvTranspose2d(256, 256, kernel_size=4, stride=2, padding=1, bias=False)
        self.batchnorm2 = nn.BatchNorm2d(256)
        self.conv = nn.Conv2d(256, cfg.num_labels, kernel_size=1, stride=1, padding=0)

    def forward(self, x):
        x = F.relu(self.batchnorm1(self.deconv1(x)))
        x = F.relu(self.batchnorm2(self.deconv2(x)))
        return self.conv(x)


class VitPose(nn.Module):
    """Crops (B, 3, H, W), normalised -> heatmaps (B, num_labels, h, w).
    Building one turns TF32 off (`sam.full_f32`): the products run in f32."""

    def __init__(self, cfg: VitPoseConfig):
        super().__init__()
        if cfg.num_experts > 1:
            raise ValueError(f"dataset_index must be provided when using multiple experts "
                             f"(num_experts={cfg.num_experts}); the detector passes none")
        full_f32()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.head = SimpleDecoder(cfg) if cfg.use_simple_decoder else ClassicDecoder(cfg)
        self.eval()

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        tokens = self.backbone(pixel_values)
        gh, gw = self.cfg.grid
        fmap = tokens.permute(0, 2, 1).reshape(tokens.shape[0], -1, gh, gw)
        return self.head(fmap)

