"""Vision Transformer (counterpart of
``vision_tpu/models/vision_transformer.py``): vit_b_16, vit_b_32,
vit_l_16, vit_l_32, vit_h_14.

NCHW input. Module and state-dict names are torchvision's
(``conv_proj``, ``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_{i}.self_attention.in_proj_weight`` ...,
``heads.head``), so torchvision checkpoints load as they are. The attention
is one packed q, k, v projection and :func:`ops.attention.
scaled_dot_product_attention`; the MLP's GELU is exact; LayerNorm's eps is
1e-6; the class token goes first, then the patches in the row-major order
of their grid.

Dropout draws from an explicit generator: ``forward(x, generator=g)``. A
model with no dropout (the default, and every published recipe's) draws
nothing and needs none.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import (
    Weights,
    WeightsEnum,
    register_model,
    resolve_device,
)
from vision_tpu_torch.ops.attention import scaled_dot_product_attention
from vision_tpu_torch.transforms._presets import ImageClassification
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = [
    "EncoderBlock",
    "SelfAttention",
    "VisionTransformer",
    "ViT_B_16_Weights",
    "ViT_B_32_Weights",
    "ViT_H_14_Weights",
    "ViT_L_16_Weights",
    "ViT_L_32_Weights",
    "init_weights",
    "vit_b_16",
    "vit_b_32",
    "vit_h_14",
    "vit_l_16",
    "vit_l_32",
]


def _dropout(x: torch.Tensor, p: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator``."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator: "
                         "forward(x, generator=...)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


class SelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (``in_proj_weight`` ``[3D,
    D]``, rows q, k, v; ``in_proj_bias``; ``out_proj``) for self-attention
    on ``[B, S, D]``. With ``dropout > 0`` in training, the scores are
    materialised and dropped as the JAX module does."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        # torch's default, as nn.Linear's (the builders draw every
        # parameter again from their seeded generator: init_weights)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.num_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, s, self.num_heads, dh).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        if self.training and self.dropout > 0:
            attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
            attn = torch.softmax(attn / math.sqrt(dh), dim=-1).to(v.dtype)
            attn = _dropout(attn, self.dropout, True, generator)
            out = torch.matmul(attn, v)
        else:
            out = scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class EncoderBlock(nn.Module):
    """Pre-norm block: ``x + attn(ln_1(x))``, then ``x + mlp(ln_2(x))``."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.self_attention = SelfAttention(hidden_dim, num_heads,
                                            attention_dropout)
        self.ln_2 = nn.LayerNorm(hidden_dim, eps=1e-6)
        # torchvision's MLPBlock indices: 0 Linear, 1 GELU, 2 Dropout,
        # 3 Linear, 4 Dropout (the dropouts run in forward, drawn from the
        # generator)
        self.mlp = nn.Sequential(OrderedDict([
            ("0", nn.Linear(hidden_dim, mlp_dim)),
            ("1", nn.GELU()),
            ("3", nn.Linear(mlp_dim, hidden_dim)),
        ]))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, train = self.dropout, self.training
        h = self.self_attention(self.ln_1(x), generator)
        x = x + _dropout(h, p, train, generator)
        fc1, gelu, fc2 = self.mlp
        y = _dropout(gelu(fc1(self.ln_2(x))), p, train, generator)
        return x + _dropout(fc2(y), p, train, generator)


class Encoder(nn.Module):
    def __init__(self, seq_length: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, dropout: float,
                 attention_dropout: float):
        super().__init__()
        self.dropout = dropout
        self.pos_embedding = nn.Parameter(torch.zeros(1, seq_length, hidden_dim))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", EncoderBlock(num_heads, hidden_dim, mlp_dim,
                                                dropout, attention_dropout))
            for i in range(num_layers)))
        self.ln = nn.LayerNorm(hidden_dim, eps=1e-6)


class VisionTransformer(nn.Module):
    """torchvision's ``VisionTransformer``. Images of another size than
    ``image_size`` (a multiple of the patch) take the position embedding's
    grid resized bicubically (``_interpolate_pos_embedding``).
    ``forward(x, return_features=True)`` also returns each encoder layer's
    output and ``encoder.ln``'s."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int,
                 num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 1000,
                 representation_size: Optional[int] = None):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        self.conv_proj = nn.Conv2d(3, hidden_dim, patch_size, patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        seq_length = (image_size // patch_size) ** 2 + 1
        self.encoder = Encoder(seq_length, num_layers, num_heads, hidden_dim,
                               mlp_dim, dropout, attention_dropout)
        heads: Dict[str, nn.Module] = OrderedDict()
        if representation_size is None:
            heads["head"] = nn.Linear(hidden_dim, num_classes)
        else:
            heads["pre_logits"] = nn.Linear(hidden_dim, representation_size)
            heads["act"] = nn.Tanh()
            heads["head"] = nn.Linear(representation_size, num_classes)
        self.heads = nn.Sequential(heads)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        n = x.shape[0]
        x = self.conv_proj(x)  # [N, D, n_h, n_w]
        n_h, n_w = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)  # row-major patches
        x = torch.cat([self.class_token.expand(n, -1, -1), x], dim=1)
        pos = self.encoder.pos_embedding
        if pos.shape[1] != n_h * n_w + 1:
            pos = _interpolate_pos_embedding(pos, n_h, n_w)
        x = _dropout(x + pos, self.dropout, self.training, generator)
        features: Dict[str, torch.Tensor] = {}
        for name, layer in self.encoder.layers.named_children():
            x = layer(x, generator)
            features[f"encoder.layers.{name}"] = x
        x = self.encoder.ln(x)
        features["encoder.ln"] = x
        logits = self.heads(x[:, 0])
        if return_features:
            return logits, features
        return logits


def _interpolate_pos_embedding(pos: torch.Tensor, n_h: int, n_w: int
                               ) -> torch.Tensor:
    """The grid part of ``pos`` (``[1, 1 + g*g, D]``) resized bicubically to
    ``n_h x n_w`` (no antialias), the class token's row kept."""
    cls, grid = pos[:, :1], pos[:, 1:]
    g = int(math.sqrt(grid.shape[1]))
    grid = grid.reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = resize_2d(grid, (n_h, n_w), mode="bicubic", antialias=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, n_h * n_w, -1)
    return torch.cat([cls, grid.to(pos.dtype)], dim=1)


@torch.no_grad()
def init_weights(model: VisionTransformer, generator: torch.Generator) -> None:
    """torchvision's initialisation, drawn from ``generator``: the patch
    projection truncated normal of std ``sqrt(1 / fan_in)`` and zero bias;
    the position embedding normal of std 0.02; attention projections
    Xavier-uniform, zero biases; MLP Linears Xavier-uniform, biases normal
    of std 1e-6; the pre-logits truncated normal of std ``sqrt(1 /
    fan_in)``; the class token and ``heads.head`` zero (as published: the
    first logits are all zero until the head is trained or seeded)."""
    fan_in = model.conv_proj.in_channels * model.patch_size ** 2
    nn.init.trunc_normal_(model.conv_proj.weight, std=math.sqrt(1.0 / fan_in),
                          generator=generator)
    model.conv_proj.bias.zero_()
    model.class_token.zero_()
    model.encoder.pos_embedding.normal_(0.0, 0.02, generator=generator)
    for block in model.encoder.layers:
        attn = block.self_attention
        nn.init.xavier_uniform_(attn.in_proj_weight, generator=generator)
        attn.in_proj_bias.zero_()
        nn.init.xavier_uniform_(attn.out_proj.weight, generator=generator)
        attn.out_proj.bias.zero_()
        fc1, _, fc2 = block.mlp
        for lin in (fc1, fc2):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            lin.bias.normal_(0.0, 1e-6, generator=generator)
    if hasattr(model.heads, "pre_logits"):
        pre = model.heads.pre_logits
        nn.init.trunc_normal_(pre.weight, std=math.sqrt(1.0 / pre.in_features),
                              generator=generator)
        pre.bias.zero_()
    model.heads.head.weight.zero_()
    model.heads.head.bias.zero_()


def _w(url: str, acc1: float, acc5: float, num_params: int, crop: int = 224,
       resize: int = 256, interp: str = "bilinear") -> Weights:
    return Weights(url=url, transforms=functools.partial(
        ImageClassification, crop_size=crop, resize_size=resize,
        interpolation=interp), meta={
        "num_params": num_params, "min_size": (crop, crop),
        "categories": "imagenet-1k",
        "_metrics": {"ImageNet-1K": {"acc@1": acc1, "acc@5": acc5}},
    })


_URL = "https://download.pytorch.org/models/"


class ViT_B_16_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w(_URL + "vit_b_16-c867db91.pth", 81.072, 95.318, 86567656)
    IMAGENET1K_SWAG_E2E_V1 = _w(_URL + "vit_b_16_swag-9ac1b537.pth", 85.304,
                                97.650, 86859496, crop=384, resize=384,
                                interp="bicubic")
    IMAGENET1K_SWAG_LINEAR_V1 = _w(_URL + "vit_b_16_lc_swag-4e70ced5.pth",
                                   81.886, 96.180, 86567656, interp="bicubic",
                                   resize=224)
    DEFAULT = IMAGENET1K_V1


class ViT_B_32_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w(_URL + "vit_b_32-d86f8d99.pth", 75.912, 92.466, 88224232)
    DEFAULT = IMAGENET1K_V1


class ViT_L_16_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w(_URL + "vit_l_16-852ce7e3.pth", 79.662, 94.638,
                       304326632, crop=224, resize=242)
    IMAGENET1K_SWAG_E2E_V1 = _w(_URL + "vit_l_16_swag-4f3808c9.pth", 88.064,
                                98.512, 305174504, crop=512, resize=512,
                                interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class ViT_L_32_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w(_URL + "vit_l_32-c7638314.pth", 76.972, 93.07, 306535400)
    DEFAULT = IMAGENET1K_V1


class ViT_H_14_Weights(WeightsEnum):
    IMAGENET1K_SWAG_E2E_V1 = _w(_URL + "vit_h_14_swag-80465313.pth", 88.552,
                                98.694, 633470440, crop=518, resize=518,
                                interp="bicubic")
    IMAGENET1K_SWAG_LINEAR_V1 = _w(_URL + "vit_h_14_lc_swag-c1eb923e.pth",
                                   85.708, 97.730, 632045800, interp="bicubic",
                                   resize=224)
    DEFAULT = IMAGENET1K_SWAG_E2E_V1


_Device = Union[str, torch.device, None]


def _vit(image_size: int, patch: int, layers: int, heads: int, hidden: int,
         mlp: int, weights: Any, device: _Device, seed: int,
         **kwargs: Any) -> VisionTransformer:
    """The model in eval mode on ``device`` (the card when None; raises
    without one; ``"meta"`` builds it without storage or initialisation).
    Without ``weights`` the parameters are torchvision's initialisation
    drawn from a CPU ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    if weights is not None:
        kwargs["num_classes"] = 1000
    with torch.device("meta" if device.type == "meta" else "cpu"):
        model = VisionTransformer(image_size, patch, layers, heads, hidden, mlp,
                                  **kwargs)
    if device.type == "meta":
        return model.eval()
    if weights is not None:
        model.load_state_dict(weights.get_state_dict())
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)


@register_model()
def vit_b_16(*, weights: Optional[ViT_B_16_Weights] = None,
             device: _Device = None, seed: int = 0,
             **kwargs: Any) -> VisionTransformer:
    weights = ViT_B_16_Weights.verify(weights)
    size = 384 if weights is ViT_B_16_Weights.IMAGENET1K_SWAG_E2E_V1 else 224
    return _vit(size, 16, 12, 12, 768, 3072, weights, device, seed, **kwargs)


@register_model()
def vit_b_32(*, weights: Optional[ViT_B_32_Weights] = None,
             device: _Device = None, seed: int = 0,
             **kwargs: Any) -> VisionTransformer:
    return _vit(224, 32, 12, 12, 768, 3072, ViT_B_32_Weights.verify(weights),
                device, seed, **kwargs)


@register_model()
def vit_l_16(*, weights: Optional[ViT_L_16_Weights] = None,
             device: _Device = None, seed: int = 0,
             **kwargs: Any) -> VisionTransformer:
    weights = ViT_L_16_Weights.verify(weights)
    size = 512 if weights is ViT_L_16_Weights.IMAGENET1K_SWAG_E2E_V1 else 224
    return _vit(size, 16, 24, 16, 1024, 4096, weights, device, seed, **kwargs)


@register_model()
def vit_l_32(*, weights: Optional[ViT_L_32_Weights] = None,
             device: _Device = None, seed: int = 0,
             **kwargs: Any) -> VisionTransformer:
    return _vit(224, 32, 24, 16, 1024, 4096, ViT_L_32_Weights.verify(weights),
                device, seed, **kwargs)


@register_model()
def vit_h_14(*, weights: Optional[ViT_H_14_Weights] = None,
             device: _Device = None, seed: int = 0,
             **kwargs: Any) -> VisionTransformer:
    weights = ViT_H_14_Weights.verify(weights)
    size = 518 if weights is ViT_H_14_Weights.IMAGENET1K_SWAG_E2E_V1 else 224
    return _vit(size, 14, 32, 16, 1280, 5120, weights, device, seed, **kwargs)
