"""Video Swin Transformer (counterpart of
``vision_tpu/models/video/swin_transformer.py``): swin3d_t, swin3d_s,
swin3d_b.

Input ``[N, C, T, H, W]``; inside, channels-last ``[N, T, H, W, C]`` as
torchvision's. torchvision's names (``patch_embed.proj``,
``patch_embed.norm``, ``features.{i}.{j}.norm1`` / ``.attn.qkv`` /
``.attn.proj`` / ``.attn.relative_position_bias_table`` / ``.norm2`` /
``.mlp.{0,3}``, the patch merging ``features.{i}.norm`` /
``.reduction``, ``norm``, ``head``); torchvision's computed
``relative_position_index`` is not a buffer here and is dropped from its
checkpoints.

As in the JAX model: the patch embedding is a convolution without padding
(a remainder of the clip is dropped, where torchvision's pads it); a
window larger than the map shrinks to it and loses its shift
(``_adjust_window``); a shrunk window's bias is the row-major prefix of the
full window's index; the map is padded to whole windows; the scores and
their softmax are f32 whatever the input type; the shift mask is -100
between regions. Stochastic depth (``"row"``, ``p * block_id / (total -
1)``) draws from ``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    default_,
    init_norms,
    trunc_normal_,
)
from vision_tpu_torch.models.swin_transformer import PatchMerging, on_device
from vision_tpu_torch.models.video._utils import video_weights
from vision_tpu_torch.ops.misc import MLP
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth

__all__ = [
    "Swin3D_B_Weights",
    "Swin3D_S_Weights",
    "Swin3D_T_Weights",
    "SwinTransformer3d",
    "swin3d_b",
    "swin3d_s",
    "swin3d_t",
]


def _rel_position_index_3d(ws: Tuple[int, int, int]) -> np.ndarray:
    """``[n, n]``: the bias table's row for each (query, key) pair of a
    ``ws`` window."""
    wd, wh, ww = ws
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


def _bias_index(window: Tuple[int, int, int], n: int) -> np.ndarray:
    """The full window's index, its ``[:n, :n]`` prefix, flattened."""
    return _rel_position_index_3d(window)[:n, :n].reshape(-1)


def _adjust_window(size, window, shift):
    """A window no larger than the map on each axis; where it is cut to
    the map, no shift."""
    ws, ss = list(window), list(shift)
    for i in range(3):
        if size[i] <= ws[i]:
            ws[i] = size[i]
            ss[i] = 0
    return tuple(ws), tuple(ss)


def _shift_mask_3d(padded: Tuple[int, int, int], ws: Tuple[int, int, int],
                   ss: Tuple[int, int, int]) -> np.ndarray:
    """``[windows, n, n]``: -100 between tokens of a shifted window that
    came from different regions of the unshifted map, else 0."""
    mask = np.zeros(padded, np.float32)
    slices = [((0, p - w), (p - w, p - s), (p - s, p))
              for p, w, s in zip(padded, ws, ss)]
    cnt = 0
    for sd in slices[0]:
        for sh in slices[1]:
            for sw in slices[2]:
                mask[sd[0]:sd[1], sh[0]:sh[1], sw[0]:sw[1]] = cnt
                cnt += 1
    (tp, hp, wp), (wd, wh, ww) = padded, ws
    m = mask.reshape(tp // wd, wd, hp // wh, wh, wp // ww, ww)
    m = m.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class ShiftedWindowAttention3d(nn.Module):
    def __init__(self, dim: int, window_size: Sequence[int],
                 shift_size: Sequence[int], num_heads: int):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        wd, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        ws, ss = _adjust_window((t, h, w), self.window_size, self.shift_size)
        wd, wh, ww = ws
        n = wd * wh * ww
        index = on_device(_bias_index, self.window_size, n, device=x.device)
        bias = self.relative_position_bias_table[index].view(n, n, -1)
        bias = bias.permute(2, 0, 1)[None]

        x = F.pad(x, (0, 0, 0, (-w) % ww, 0, (-h) % wh, 0, (-t) % wd))
        tp, hp, wp = x.shape[1:4]
        shifted = sum(ss) > 0
        if shifted:
            x = torch.roll(x, (-ss[0], -ss[1], -ss[2]), (1, 2, 3))
        nt, nh, nw = tp // wd, hp // wh, wp // ww
        x = x.reshape(b, nt, wd, nh, wh, nw, ww, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, n, c)
        heads = self.num_heads
        q, k, v = self.qkv(x).reshape(-1, n, 3, heads, c // heads).permute(
            2, 0, 3, 1, 4)
        q = q * (c // heads) ** -0.5
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1)) + bias
        if shifted:
            mask = on_device(_shift_mask_3d, (tp, hp, wp), ws, ss,
                             device=x.device)
            attn = attn.view(b, -1, heads, n, n) + mask[None, :, None]
            attn = attn.view(-1, heads, n, n)
        attn = torch.softmax(attn, -1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(-1, n, c)
        out = self.proj(out).view(b, nt, nh, nw, wd, wh, ww, c)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, tp, hp, wp, c)
        if shifted:
            out = torch.roll(out, ss, (1, 2, 3))
        return out[:, :t, :h, :w]


class SwinTransformerBlock(nn.Module):
    """Pre-norm residual window attention and MLP (exact GELU), each
    through stochastic depth."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift_size: Sequence[int], mlp_ratio: float, sd_prob: float):
        super().__init__()
        self.sd_prob = sd_prob
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftedWindowAttention3d(dim, window_size, shift_size,
                                             num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLP(dim, [int(dim * mlp_ratio), dim],
                       activation_layer=nn.GELU, inplace=None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def sd(t):
            return stochastic_depth(t, self.sd_prob, "row", self.training,
                                    generator=generator)

        x = x + sd(self.attn(self.norm1(x)))
        return x + sd(self.mlp(self.norm2(x)))


class _PatchEmbed3d(nn.Module):
    def __init__(self, patch_size: Sequence[int], embed_dim: int):
        super().__init__()
        self.proj = nn.Conv3d(3, embed_dim, tuple(patch_size),
                              tuple(patch_size))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).permute(0, 2, 3, 4, 1))


class SwinTransformer3d(nn.Module):
    """``forward(x, return_features=True)`` also returns the channels-last
    patch embedding (``patch_embed``) and each stage's output
    (``features.{i}``)."""

    def __init__(self, patch_size: Sequence[int] = (2, 4, 4),
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: Sequence[int] = (8, 7, 7),
                 mlp_ratio: float = 4.0, stochastic_depth_prob: float = 0.1,
                 num_classes: int = 400):
        super().__init__()
        self.patch_embed = _PatchEmbed3d(patch_size, embed_dim)
        layers: List[nn.Module] = []
        total = sum(depths)
        block_id = 0
        for i_stage, depth in enumerate(depths):
            dim = embed_dim * 2 ** i_stage
            stage = []
            for i_layer in range(depth):
                sd = stochastic_depth_prob * block_id / (total - 1)
                shift = [0 if i_layer % 2 == 0 else w // 2 for w in window_size]
                stage.append(SwinTransformerBlock(
                    dim, num_heads[i_stage], window_size, shift, mlp_ratio, sd))
                block_id += 1
            layers.append(nn.Sequential(*stage))
            if i_stage < len(depths) - 1:
                layers.append(PatchMerging(dim))
        self.features = nn.Sequential(*layers)
        num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(num_features, eps=1e-5)
        self.head = nn.Linear(num_features, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.patch_embed(x)
        features: Dict[str, torch.Tensor] = {"patch_embed": x}
        for i, layer in enumerate(self.features):
            if isinstance(layer, PatchMerging):
                x = layer(x)
                continue
            for block in layer:
                x = block(x, generator)
            features[f"features.{i}"] = x
        logits = self.head(self.norm(x).mean((1, 2, 3)))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: Linears truncated normal of std 0.02 with zero bias,
    the bias tables truncated normal of std 0.02, the patch convolution
    PyTorch's default; norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv3d):
            default_(m, generator)
        elif isinstance(m, ShiftedWindowAttention3d):
            trunc_normal_(m.relative_position_bias_table, 0.02, generator)


def _checkpoint_hook(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision's state dict as the port's: its computed index dropped."""
    return {k: v for k, v in state.items()
            if not k.endswith("relative_position_index")}


class Swin3D_T_Weights(WeightsEnum):
    KINETICS400_V1 = video_weights("swin3d_t-7615ae03.pth", 77.715, 93.519,
                                   28158070, 43.882)
    DEFAULT = KINETICS400_V1


class Swin3D_S_Weights(WeightsEnum):
    KINETICS400_V1 = video_weights("swin3d_s-da41c237.pth", 79.521, 94.158,
                                   49816678, 82.841)
    DEFAULT = KINETICS400_V1


class Swin3D_B_Weights(WeightsEnum):
    KINETICS400_V1 = video_weights("swin3d_b_1k-24f7c7c6.pth", 79.427, 94.386,
                                   88048984, 140.667)
    KINETICS400_IMAGENET22K_V1 = video_weights(
        "swin3d_b_22k-7c6ae6fa.pth", 81.643, 95.574, 88048984, 140.667)
    DEFAULT = KINETICS400_V1


def _swin3d(dim, depths, heads, sd_prob, weights, device: Device, seed: int,
            **kwargs: Any) -> SwinTransformer3d:
    sd_prob = kwargs.pop("stochastic_depth_prob", sd_prob)
    return build(lambda: SwinTransformer3d(
        embed_dim=dim, depths=depths, num_heads=heads,
        stochastic_depth_prob=sd_prob, **kwargs),
        init_weights, weights, device, seed, _checkpoint_hook)


@register_model()
def swin3d_t(*, weights: Optional[Swin3D_T_Weights] = None,
             device: Device = None, seed: int = 0,
             **kwargs: Any) -> SwinTransformer3d:
    return _swin3d(96, [2, 2, 6, 2], [3, 6, 12, 24], 0.1,
                   Swin3D_T_Weights.verify(weights), device, seed, **kwargs)


@register_model()
def swin3d_s(*, weights: Optional[Swin3D_S_Weights] = None,
             device: Device = None, seed: int = 0,
             **kwargs: Any) -> SwinTransformer3d:
    return _swin3d(96, [2, 2, 18, 2], [3, 6, 12, 24], 0.1,
                   Swin3D_S_Weights.verify(weights), device, seed, **kwargs)


@register_model()
def swin3d_b(*, weights: Optional[Swin3D_B_Weights] = None,
             device: Device = None, seed: int = 0,
             **kwargs: Any) -> SwinTransformer3d:
    return _swin3d(128, [2, 2, 18, 2], [4, 8, 16, 32], 0.1,
                   Swin3D_B_Weights.verify(weights), device, seed, **kwargs)
