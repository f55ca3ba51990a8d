"""Swin Transformer v1 and v2 (counterpart of
``vision_tpu/models/swin_transformer.py``): swin_t/s/b, swin_v2_t/s/b.

NCHW input; inside, the model is channels-last as torchvision's is
(``features.0`` is the patch convolution, a ``Permute`` and LayerNorm).
Module and state-dict names are torchvision's (``features.{i}.{j}.attn.qkv``,
``.relative_position_bias_table``, v2's ``.logit_scale`` and
``.cpb_mlp.{0,2}``, ``features.{i}.reduction``, ``norm``, ``head``);
torchvision's computed buffers (``relative_position_index``, v2's
``relative_coords_table``) are not parameters here and are dropped from
its checkpoints, as the JAX package's converter drops them.

Windowed attention: pad to whole windows, no shift on an axis whose padded
size is at most the window, roll, partition, q k v, the scores and their
softmax in f32 whatever the input type, the -100 shift mask, the reverse
roll and the crop. The relative position index, v2's coordinates table
and each padded shape's shift mask are built once per device.

v2's key bias is NOT zeroed at every forward as torchvision does: like
the JAX reference, only a checkpoint's (at load) and the initialisation's
k slice of ``qkv.bias`` start at zero, and in training that slice learns.
Stochastic depth (``"row"``, ``p * block_id / (total - 1)``) draws from
``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    cls_weights as _w,
    default_,
    init_norms,
    trunc_normal_,
)
from vision_tpu_torch.ops.misc import MLP, Permute
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth

__all__ = [
    "SwinTransformer",
    "Swin_T_Weights",
    "Swin_S_Weights",
    "Swin_B_Weights",
    "Swin_V2_T_Weights",
    "Swin_V2_S_Weights",
    "Swin_V2_B_Weights",
    "swin_t",
    "swin_s",
    "swin_b",
    "swin_v2_t",
    "swin_v2_s",
    "swin_v2_b",
]


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """``[wh*ww * wh*ww]``: for each (query, key) pair of a window, the row
    of the relative position bias table of their offset."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).reshape(-1)


def relative_coords_table(wh: int, ww: int) -> np.ndarray:
    """v2's ``[1, 2wh-1, 2ww-1, 2]`` log-spaced offsets, the input of the
    continuous position bias MLP."""
    ch = np.arange(-(wh - 1), wh, dtype=np.float32)
    cw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij")).transpose(1, 2, 0)[None]
    table[..., 0] /= wh - 1
    table[..., 1] /= ww - 1
    table *= 8
    return np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0


def shift_mask(pad_h: int, pad_w: int, window: Tuple[int, int],
               shift: Tuple[int, int]) -> np.ndarray:
    """``[windows, n, n]``: -100 where a query and a key of a shifted window
    came from different regions of the unshifted map, else 0."""
    mask = np.zeros((pad_h, pad_w), dtype=np.float32)
    h_slices = ((0, pad_h - window[0]), (pad_h - window[0], pad_h - shift[0]),
                (pad_h - shift[0], pad_h))
    w_slices = ((0, pad_w - window[1]), (pad_w - window[1], pad_w - shift[1]),
                (pad_w - shift[1], pad_w))
    count = 0
    for h0, h1 in h_slices:
        for w0, w1 in w_slices:
            mask[h0:h1, w0:w1] = count
            count += 1
    nh, nw = pad_h // window[0], pad_w // window[1]
    mask = mask.reshape(nh, window[0], nw, window[1]).transpose(0, 2, 1, 3)
    mask = mask.reshape(nh * nw, window[0] * window[1])
    diff = mask[:, None, :] - mask[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=256)
def on_device(fn, *args, device: torch.device) -> torch.Tensor:
    """``fn(*args)`` (numpy) as a tensor on ``device``, made once. Never an
    inference tensor, so that autograd may save it later."""
    with torch.inference_mode(False):
        return torch.from_numpy(fn(*args)).to(device)


def shifted_window_attention(
    x: torch.Tensor, qkv: nn.Linear, proj: nn.Linear,
    relative_position_bias: torch.Tensor, window: Sequence[int],
    num_heads: int, shift: Sequence[int],
    logit_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head self-attention inside the (shifted) windows of
    channels-last ``x`` ``[B, H, W, C]``; ``relative_position_bias``
    ``[1, heads, n, n]``; v2's cosine attention where ``logit_scale`` is
    given."""
    b, h, w, c = x.shape
    wh, ww = window
    x = F.pad(x, (0, 0, 0, (ww - w % ww) % ww, 0, (wh - h % wh) % wh))
    pad_h, pad_w = x.shape[1:3]
    sh = 0 if wh >= pad_h else shift[0]
    sw = 0 if ww >= pad_w else shift[1]
    if sh + sw > 0:
        x = torch.roll(x, (-sh, -sw), (1, 2))
    nh, nw, n = pad_h // wh, pad_w // ww, wh * ww
    x = x.reshape(b, nh, wh, nw, ww, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b * nh * nw, n, c)
    q, k, v = qkv(x).reshape(-1, n, 3, num_heads, c // num_heads).permute(
        2, 0, 3, 1, 4)
    if logit_scale is not None:
        q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
        attn = attn * torch.exp(logit_scale.clamp(max=math.log(100.0)))
    else:
        q = q * (c // num_heads) ** -0.5
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
    attn = attn + relative_position_bias
    if sh + sw > 0:
        mask = on_device(shift_mask, pad_h, pad_w, (wh, ww), (sh, sw),
                         device=x.device)
        attn = attn.view(b, nh * nw, num_heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, num_heads, n, n)
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(-1, n, c)
    out = proj(out).view(b, nh, nw, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, pad_h, pad_w, c)
    if sh + sw > 0:
        out = torch.roll(out, (sh, sw), (1, 2))
    return out[:, :h, :w, :]


class ShiftedWindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: Sequence[int],
                 shift_size: Sequence[int], num_heads: int, v2: bool = False):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.num_heads = num_heads
        self.v2 = v2
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        wh, ww = self.window_size
        if v2:
            self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1),
                                                       math.log(10.0)))
            self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                         nn.Linear(512, num_heads, bias=False))
        else:
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads))

    def relative_position_bias(self) -> torch.Tensor:
        """``[1, heads, n, n]``; v2's from its MLP, in f32 (the table is
        f32 and the JAX MLP promotes to it)."""
        wh, ww = self.window_size
        n = wh * ww
        dev = self.qkv.weight.device
        index = on_device(relative_position_index, wh, ww, device=dev)
        if self.v2:
            table = on_device(relative_coords_table, wh, ww, device=dev)
            fc1, _, fc2 = self.cpb_mlp
            t = F.relu(F.linear(table, fc1.weight.float(), fc1.bias.float()))
            table = F.linear(t, fc2.weight.float()).view(-1, self.num_heads)
        else:
            table = self.relative_position_bias_table
        bias = table[index].view(n, n, -1).permute(2, 0, 1)[None]
        return 16.0 * torch.sigmoid(bias) if self.v2 else bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return shifted_window_attention(
            x, self.qkv, self.proj, self.relative_position_bias(),
            self.window_size, self.num_heads, self.shift_size,
            self.logit_scale if self.v2 else None)


class SwinTransformerBlock(nn.Module):
    """Pre-norm (v1) or post-norm (v2) residual attention and MLP (exact
    GELU), each through stochastic depth."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift_size: Sequence[int], mlp_ratio: float, sd_prob: float,
                 v2: bool = False):
        super().__init__()
        self.v2 = v2
        self.sd_prob = sd_prob
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftedWindowAttention(dim, window_size, shift_size,
                                           num_heads, v2)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLP(dim, [int(dim * mlp_ratio), dim],
                       activation_layer=nn.GELU, inplace=None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def sd(t):
            return stochastic_depth(t, self.sd_prob, "row", self.training,
                                    generator=generator)

        if self.v2:
            x = x + sd(self.norm1(self.attn(x)))
            return x + sd(self.norm2(self.mlp(x)))
        x = x + sd(self.attn(self.norm1(x)))
        return x + sd(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """Each 2x2 patch's four tokens concatenated (odd sizes padded),
    then LayerNorm and the reduction to ``2 * dim`` (v1) or the reduction,
    then LayerNorm (v2)."""

    def __init__(self, dim: int, v2: bool = False):
        super().__init__()
        self.v2 = v2
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim if v2 else 4 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3:-1]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[..., 0::2, 0::2, :], x[..., 1::2, 0::2, :],
                       x[..., 0::2, 1::2, :], x[..., 1::2, 1::2, :]], -1)
        if self.v2:
            return self.norm(self.reduction(x))
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """torchvision's ``SwinTransformer`` (v1, or v2 with ``v2=True``).
    ``forward(x, return_features=True)`` also returns each stage's
    channels-last output under ``stage{i}``."""

    def __init__(self, patch_size: Sequence[int], embed_dim: int,
                 depths: Sequence[int], num_heads: Sequence[int],
                 window_size: Sequence[int], mlp_ratio: float = 4.0,
                 stochastic_depth_prob: float = 0.1, num_classes: int = 1000,
                 v2: bool = False):
        super().__init__()
        layers: List[nn.Module] = [nn.Sequential(
            nn.Conv2d(3, embed_dim, tuple(patch_size), tuple(patch_size)),
            Permute([0, 2, 3, 1]), nn.LayerNorm(embed_dim, eps=1e-5))]
        total = sum(depths)
        block_id = 0
        for i_stage, depth in enumerate(depths):
            dim = embed_dim * 2 ** i_stage
            stage = []
            for i_layer in range(depth):
                sd = stochastic_depth_prob * block_id / (total - 1)
                shift = [0 if i_layer % 2 == 0 else w // 2 for w in window_size]
                stage.append(SwinTransformerBlock(
                    dim, num_heads[i_stage], window_size, shift, mlp_ratio, sd,
                    v2))
                block_id += 1
            layers.append(nn.Sequential(*stage))
            if i_stage < len(depths) - 1:
                layers.append(PatchMerging(dim, v2))
        self.features = nn.Sequential(*layers)
        num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(num_features, eps=1e-5)
        self.head = nn.Linear(num_features, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.features[0](x)
        features: Dict[str, torch.Tensor] = {}
        for layer in self.features[1:]:
            if isinstance(layer, PatchMerging):
                x = layer(x)
                continue
            for block in layer:
                x = block(x, generator)
            features[f"stage{len(features)}"] = x
        logits = self.head(self.norm(x).mean((1, 2)))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: Linears (v2's position MLP too) truncated normal of
    std 0.02, zero bias (so v2's key bias starts at zero); v1's bias
    tables truncated normal of std 0.02; v2's logit scale log 10; the
    patch convolution PyTorch's default; norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            default_(m, generator)
        elif isinstance(m, ShiftedWindowAttention):
            if m.v2:
                m.logit_scale.fill_(math.log(10.0))
            else:
                trunc_normal_(m.relative_position_bias_table, 0.02, generator)


def _checkpoint_hook(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision's state dict as the port's: its computed buffers
    dropped, and v2's key bias zeroed once, as the JAX converter does."""
    out = {}
    for k, v in state.items():
        if k.endswith(("relative_position_index", "relative_coords_table")):
            continue
        if k.endswith("attn.qkv.bias") and k.replace(
                "qkv.bias", "logit_scale") in state:
            v = v.clone()
            v[v.numel() // 3: 2 * v.numel() // 3] = 0
        out[k] = v
    return out


class Swin_T_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("swin_t-704ceda3.pth", 81.474, 95.776, 28288354, 4.491,
                       resize=232, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class Swin_S_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("swin_s-5e29d889.pth", 83.196, 96.36, 49606258, 8.741,
                       resize=246, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class Swin_B_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("swin_b-68c6b09e.pth", 83.582, 96.64, 87768224, 15.431,
                       resize=238, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class Swin_V2_T_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("swin_v2_t-b137f0e2.pth", 82.072, 96.132, 28351570,
                       5.94, crop=256, resize=260, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class Swin_V2_S_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("swin_v2_s-637d8ceb.pth", 83.712, 96.816, 49737442,
                       11.546, crop=256, resize=260, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


class Swin_V2_B_Weights(WeightsEnum):
    IMAGENET1K_V1 = _w("swin_v2_b-781e5279.pth", 84.112, 96.864, 87930848,
                       20.325, crop=256, resize=272, interp="bicubic")
    DEFAULT = IMAGENET1K_V1


def _swin(patch, dim, depths, heads, window, sd_prob, weights_enum, weights,
          device: Device, seed: int, v2: bool = False,
          **kwargs: Any) -> SwinTransformer:
    weights = weights_enum.verify(weights)
    sd_prob = kwargs.pop("stochastic_depth_prob", sd_prob)
    return build(lambda: SwinTransformer(patch, dim, depths, heads, window,
                                         stochastic_depth_prob=sd_prob, v2=v2,
                                         **kwargs),
                 init_weights, weights, device, seed, _checkpoint_hook)


@register_model()
def swin_t(*, weights: Optional[Swin_T_Weights] = None, device: Device = None,
           seed: int = 0, **kwargs: Any) -> SwinTransformer:
    return _swin([4, 4], 96, [2, 2, 6, 2], [3, 6, 12, 24], [7, 7], 0.2,
                 Swin_T_Weights, weights, device, seed, **kwargs)


@register_model()
def swin_s(*, weights: Optional[Swin_S_Weights] = None, device: Device = None,
           seed: int = 0, **kwargs: Any) -> SwinTransformer:
    return _swin([4, 4], 96, [2, 2, 18, 2], [3, 6, 12, 24], [7, 7], 0.3,
                 Swin_S_Weights, weights, device, seed, **kwargs)


@register_model()
def swin_b(*, weights: Optional[Swin_B_Weights] = None, device: Device = None,
           seed: int = 0, **kwargs: Any) -> SwinTransformer:
    return _swin([4, 4], 128, [2, 2, 18, 2], [4, 8, 16, 32], [7, 7], 0.5,
                 Swin_B_Weights, weights, device, seed, **kwargs)


@register_model()
def swin_v2_t(*, weights: Optional[Swin_V2_T_Weights] = None,
              device: Device = None, seed: int = 0,
              **kwargs: Any) -> SwinTransformer:
    return _swin([4, 4], 96, [2, 2, 6, 2], [3, 6, 12, 24], [8, 8], 0.2,
                 Swin_V2_T_Weights, weights, device, seed, v2=True, **kwargs)


@register_model()
def swin_v2_s(*, weights: Optional[Swin_V2_S_Weights] = None,
              device: Device = None, seed: int = 0,
              **kwargs: Any) -> SwinTransformer:
    return _swin([4, 4], 96, [2, 2, 18, 2], [3, 6, 12, 24], [8, 8], 0.3,
                 Swin_V2_S_Weights, weights, device, seed, v2=True, **kwargs)


@register_model()
def swin_v2_b(*, weights: Optional[Swin_V2_B_Weights] = None,
              device: Device = None, seed: int = 0,
              **kwargs: Any) -> SwinTransformer:
    return _swin([4, 4], 128, [2, 2, 18, 2], [4, 8, 16, 32], [8, 8], 0.5,
                 Swin_V2_B_Weights, weights, device, seed, v2=True, **kwargs)
