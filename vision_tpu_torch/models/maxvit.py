"""MaxViT-T (counterpart of ``vision_tpu/models/maxvit.py``).

NCHW input; torchvision's module and state-dict names
(``stem.{0,1}``, ``blocks.{i}.layers.{j}.layers.{MBconv,window_attention,
grid_attention}``, ``.attn_layer.1.relative_position_bias_table``,
``classifier.{2,3,5}``); torchvision's computed ``relative_position_index``
buffers are not kept and are dropped from its checkpoints. Each layer is an
MBConv (pre-norm, squeeze-excitation, an average-pool projection on the
shortcut where it strides), then attention within windows, then within
the grid, each with its MLP. The keys are scaled by the feature width's
``** -0.5``, not the head width's (a quirk of torchvision kept by the JAX
reference); the scores and their softmax are f32 whatever the input type.
Batch norm eps 1e-3, torch momentum 0.01. Stochastic depth (``"row"``,
probabilities linear from 0) draws from ``forward(x, generator=g)`` in
training mode.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    cls_weights as _w,
    init_norms,
    normal_,
    trunc_normal_,
    zero_bias_,
)
from vision_tpu_torch.models.swin_transformer import (
    on_device,
    relative_position_index,
)
from vision_tpu_torch.ops.misc import (
    BatchNorm2d,
    Conv2dNormActivation,
    SqueezeExcitation,
)
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth

__all__ = ["MaxVit", "MaxVit_T_Weights", "maxvit_t"]

_BN = functools.partial(BatchNorm2d, eps=1e-3, momentum=0.01)


class MBConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, expansion: float,
                 squeeze: float, stride: int, sd_prob: float):
        super().__init__()
        self.sd_prob = sd_prob
        if stride != 1 or in_channels != out_channels:
            proj: List[nn.Module] = []
            if stride == 2:
                proj.append(nn.AvgPool2d(3, 2, 1))  # counts the padding
            proj.append(nn.Conv2d(in_channels, out_channels, 1))
            self.proj = nn.Sequential(*proj)
        else:
            self.proj = nn.Identity()
        mid = int(out_channels * expansion)
        self.layers = nn.Sequential(OrderedDict(
            pre_norm=_BN(in_channels),
            conv_a=Conv2dNormActivation(in_channels, mid, 1, norm_layer=_BN,
                                        activation_layer=nn.GELU, inplace=None),
            conv_b=Conv2dNormActivation(mid, mid, 3, stride, groups=mid,
                                        norm_layer=_BN,
                                        activation_layer=nn.GELU, inplace=None),
            squeeze_excitation=SqueezeExcitation(
                mid, int(out_channels * squeeze), activation=nn.SiLU),
            conv_c=nn.Conv2d(mid, out_channels, 1),
        ))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = stochastic_depth(self.layers(x), self.sd_prob, "row",
                               self.training, generator=generator)
        return self.proj(x) + out


class RelativePositionalMultiHeadAttention(nn.Module):
    """Attention over ``[B, G, P, D]`` partitions of P = size**2 tokens,
    with a learned bias for each relative offset."""

    def __init__(self, feat_dim: int, head_dim: int, max_seq_len: int):
        super().__init__()
        self.n_heads = feat_dim // head_dim
        self.head_dim = head_dim
        self.size = int(math.sqrt(max_seq_len))
        self.to_qkv = nn.Linear(feat_dim, 3 * self.n_heads * head_dim)
        self.merge = nn.Linear(self.n_heads * head_dim, feat_dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * self.size - 1) ** 2, self.n_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, g, p, d = x.shape
        h = self.n_heads
        q, k, v = (t.reshape(b, g, p, h, self.head_dim).transpose(2, 3)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        k = k * d ** -0.5
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
        index = on_device(relative_position_index, self.size, self.size,
                          device=x.device)
        bias = self.relative_position_bias_table[index].view(p, p, h)
        attn = attn + bias.permute(2, 0, 1)[None, None]
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(2, 3).reshape(b, g, p, d)
        return self.merge(out)


class PartitionAttentionLayer(nn.Module):
    """Window (``p`` = the partition size) or grid (``p`` = the number of
    partitions a side) partition of NCHW input, then pre-norm attention
    and MLP residuals, each through stochastic depth."""

    def __init__(self, in_channels: int, head_dim: int, partition_size: int,
                 partition_type: str, mlp_ratio: int, sd_prob: float):
        super().__init__()
        self.partition_size = partition_size
        self.partition_type = partition_type
        self.sd_prob = sd_prob
        self.attn_layer = nn.Sequential(
            nn.LayerNorm(in_channels),
            RelativePositionalMultiHeadAttention(in_channels, head_dim,
                                                 partition_size ** 2),
            nn.Dropout(0.0))
        self.mlp_layer = nn.Sequential(
            nn.LayerNorm(in_channels),
            nn.Linear(in_channels, in_channels * mlp_ratio), nn.GELU(),
            nn.Linear(in_channels * mlp_ratio, in_channels), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        grid = self.partition_type == "grid"
        p = h // self.partition_size if grid else self.partition_size
        gh, gw = h // p, w // p
        t = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
        t = t.reshape(b, gh * gw, p * p, c)
        if grid:
            t = t.transpose(-2, -3)

        def sd(v):
            return stochastic_depth(v, self.sd_prob, "row", self.training,
                                    generator=generator)

        t = t + sd(self.attn_layer[1](self.attn_layer[0](t)))
        t = t + sd(self.mlp_layer(t))
        if grid:
            t = t.transpose(-2, -3)
        t = t.reshape(b, gh, gw, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return t.reshape(b, c, h, w)


class MaxVitLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 head_dim: int, partition_size: int, expansion: float,
                 squeeze: float, mlp_ratio: int, sd_prob: float):
        super().__init__()
        self.layers = nn.Sequential(OrderedDict(
            MBconv=MBConv(in_channels, out_channels, expansion, squeeze, stride,
                          sd_prob),
            window_attention=PartitionAttentionLayer(
                out_channels, head_dim, partition_size, "window", mlp_ratio,
                sd_prob),
            grid_attention=PartitionAttentionLayer(
                out_channels, head_dim, partition_size, "grid", mlp_ratio,
                sd_prob),
        ))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, generator)
        return x


class MaxVitBlock(nn.Module):
    def __init__(self, layers: List[MaxVitLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class MaxVit(nn.Module):
    """torchvision's ``MaxVit``. ``forward(x, return_features=True)`` also
    returns each block's output under ``blocks.{i}``."""

    def __init__(self, stem_channels: int = 64,
                 block_channels=(64, 128, 256, 512), block_layers=(2, 2, 5, 2),
                 head_dim: int = 32, partition_size: int = 7,
                 stochastic_depth_prob: float = 0.2, expansion: float = 4.0,
                 squeeze: float = 0.25, mlp_ratio: int = 4,
                 num_classes: int = 1000):
        super().__init__()
        self.stem = nn.Sequential(
            Conv2dNormActivation(3, stem_channels, 3, 2, norm_layer=_BN,
                                 activation_layer=nn.GELU, inplace=None),
            Conv2dNormActivation(stem_channels, stem_channels, 3,
                                 norm_layer=None, activation_layer=None))
        p_sto = np.linspace(0, stochastic_depth_prob, sum(block_layers)).tolist()
        blocks, cin, i = [], stem_channels, 0
        for cout, n in zip(block_channels, block_layers):
            layers = []
            for j in range(n):
                layers.append(MaxVitLayer(cin if j == 0 else cout, cout,
                                          2 if j == 0 else 1, head_dim,
                                          partition_size, expansion, squeeze,
                                          mlp_ratio, p_sto[i]))
                i += 1
            blocks.append(MaxVitBlock(layers))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        last = block_channels[-1]
        self.classifier = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.LayerNorm(last),
            nn.Linear(last, last), nn.Tanh(),
            nn.Linear(last, num_classes, bias=False))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.stem(x)
        features: Dict[str, torch.Tensor] = {}
        for i, block in enumerate(self.blocks):
            for layer in block.layers:
                x = layer(x, generator)
            features[f"blocks.{i}"] = x
        logits = self.classifier(x)
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: convs and Linears normal of std 0.02, zero bias;
    the bias tables truncated normal of std 0.02; norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            normal_(m.weight, 0.02, generator)
            zero_bias_(m)
        elif isinstance(m, RelativePositionalMultiHeadAttention):
            trunc_normal_(m.relative_position_bias_table, 0.02, generator)


def _checkpoint_hook(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state.items()
            if not k.endswith("relative_position_index")}


class MaxVit_T_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("maxvit_t-bc5ab103.pth", 83.7, 96.722, 30919624, 5.558,
                       resize=224, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


@register_model()
def maxvit_t(*, weights: Optional[MaxVit_T_Weights] = None,
             device: Device = None, seed: int = 0, **kwargs: Any) -> MaxVit:
    weights = MaxVit_T_Weights.verify(weights)
    return build(lambda: MaxVit(**kwargs), init_weights, weights, device, seed,
                 _checkpoint_hook)
