"""MViT v1 and v2 (counterpart of ``vision_tpu/models/video/mvit.py``):
mvit_v1_b, mvit_v2_s.

Input ``[N, C, T, H, W]`` at the size the model was built for
(``spatial_size``, ``temporal_size``: the positional tables and v2's
relative-position tables are sized from it). torchvision's names
(``conv_proj``, ``pos_encoding.{class_token, spatial_pos, temporal_pos,
class_pos}``, ``blocks.{i}.norm1`` / ``.attn.qkv`` / ``.attn.pool_{q,k,v}
.pool`` / ``.norm_act.0`` / ``.attn.rel_pos_{h,w,t}`` / ``.attn.project.0``
/ ``.norm2`` / ``.mlp.{0,3}`` / ``.project``, ``norm``, ``head.1``).

Pooled attention as in the JAX model: q, k and v pooled over the tokens'
(T, H, W) grid by a depthwise 3-D convolution (or the skip path by a max
pool whose padding is -inf), the class token passed through, then
LayerNorm (eps 1e-6); the scores and their softmax in f32; v2's decomposed
relative positions over t, h and w, each table resampled (linear) to the
pair's offsets; v2's residual pooling adds the pooled q but its class
token. Stochastic depth (``"row"``, ``p * i / (blocks - 1)``) and the
head's dropout draw from ``forward(x, generator=g)`` in training mode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

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
from vision_tpu_torch.models.swin_transformer import on_device
from vision_tpu_torch.models.video._utils import video_weights
from vision_tpu_torch.ops.misc import dropout as _dropout
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth
from vision_tpu_torch.transforms.v2.functional._resample import (
    resample_matrix,
)

__all__ = [
    "MSBlockConfig",
    "MViT",
    "MViT_V1_B_Weights",
    "MViT_V2_S_Weights",
    "mvit_v1_b",
    "mvit_v2_s",
]

Thw = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class MSBlockConfig:
    num_heads: int
    input_channels: int
    output_channels: int
    kernel_q: Tuple[int, ...]
    kernel_kv: Tuple[int, ...]
    stride_q: Tuple[int, ...]
    stride_kv: Tuple[int, ...]


def _prod(s) -> int:
    return int(np.prod(s)) if len(s) else 1


class _TokenPool(nn.Module):
    """``[N, heads, 1 + T*H*W, d]`` tokens pooled over their (T, H, W) grid
    (depthwise convolution, or max pool), the class token passed through,
    then LayerNorm where ``norm``; returns the tokens and the pooled grid."""

    def __init__(self, dim: int, kernel: Sequence[int], stride: Sequence[int],
                 kind: str = "conv", norm: bool = True):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding = tuple(k // 2 for k in kernel)
        self.pool = (nn.Conv3d(dim, dim, self.kernel, self.stride,
                               self.padding, groups=dim, bias=False)
                     if kind == "conv" else None)
        self.norm_act = (nn.Sequential(nn.LayerNorm(dim, eps=1e-6))
                         if norm else None)

    def forward(self, x: torch.Tensor, thw: Thw):
        b, h, _, d = x.shape
        cls, tok = x[:, :, :1], x[:, :, 1:]
        tok = tok.reshape(b * h, *thw, d).permute(0, 4, 1, 2, 3)
        if self.pool is not None:
            tok = self.pool(tok)
        else:
            tok = F.max_pool3d(tok, self.kernel, self.stride, self.padding)
        out_thw = tuple(tok.shape[2:])
        tok = tok.permute(0, 2, 3, 4, 1).reshape(b, h, -1, d)
        out = torch.cat([cls, tok], 2)
        if self.norm_act is not None:
            out = self.norm_act(out)
        return out, out_thw


def _interp_embedding(emb: torch.Tensor, d: int) -> torch.Tensor:
    """``F.interpolate(mode="linear")`` of a table over its first axis to
    ``d`` rows."""
    if emb.shape[0] == d:
        return emb
    w = on_device(resample_matrix, emb.shape[0], d, "linear", False,
                  device=emb.device)
    return w @ emb.to(w.dtype)


def _dist(qs: int, ks: int) -> np.ndarray:
    qr, kr = max(ks / qs, 1.0), max(qs / ks, 1.0)
    return (np.arange(qs)[:, None] * qr
            - (np.arange(ks)[None, :] + (1.0 - ks)) * kr).astype(np.int64)


def _add_rel_pos(attn, q, q_thw: Thw, k_thw: Thw, rel_pos_h, rel_pos_w,
                 rel_pos_t) -> torch.Tensor:
    """``attn`` plus the decomposed relative positions of every
    (non-class) query and key."""
    (q_t, q_h, q_w), (k_t, k_h, k_w) = q_thw, k_thw
    dev = q.device
    rh = _interp_embedding(rel_pos_h, 2 * max(q_h, k_h) - 1)[
        on_device(_dist, q_h, k_h, device=dev)]
    rw = _interp_embedding(rel_pos_w, 2 * max(q_w, k_w) - 1)[
        on_device(_dist, q_w, k_w, device=dev)]
    rt = _interp_embedding(rel_pos_t, 2 * max(q_t, k_t) - 1)[
        on_device(_dist, q_t, k_t, device=dev)]
    b, heads, _, dim = q.shape
    dt = torch.promote_types(q.dtype, rh.dtype)  # as the JAX einsum promotes
    rh, rw, rt = rh.to(dt), rw.to(dt), rt.to(dt)
    r_q = q[:, :, 1:].to(dt).reshape(b, heads, q_t, q_h, q_w, dim)
    rel_h = torch.einsum("bythwc,hkc->bythwk", r_q, rh)
    rel_w = torch.einsum("bythwc,wkc->bythwk", r_q, rw)
    rel_t = torch.einsum("bythwc,tkc->bythwk", r_q, rt)
    rel = (rel_h[:, :, :, :, :, None, :, None]
           + rel_w[:, :, :, :, :, None, None, :]
           + rel_t[:, :, :, :, :, :, None, None])
    rel = rel.reshape(b, heads, q_t * q_h * q_w, k_t * k_h * k_w)
    return attn + F.pad(rel, (1, 0, 1, 0))


class MultiscaleAttention(nn.Module):
    def __init__(self, input_size: Thw, embed_dim: int, output_dim: int,
                 cnf: MSBlockConfig, residual_pool: bool,
                 residual_with_cls_embed: bool, rel_pos_embed: bool):
        super().__init__()
        self.num_heads = cnf.num_heads
        self.output_dim = output_dim
        self.head_dim = output_dim // cnf.num_heads
        self.residual_pool = residual_pool
        self.residual_with_cls_embed = residual_with_cls_embed
        self.qkv = nn.Linear(embed_dim, 3 * output_dim)
        self.project = nn.Sequential(nn.Linear(output_dim, output_dim))
        hd = self.head_dim
        self.pool_q = (_TokenPool(hd, cnf.kernel_q, cnf.stride_q)
                       if _prod(cnf.kernel_q) > 1 or _prod(cnf.stride_q) > 1
                       else None)
        if _prod(cnf.kernel_kv) > 1 or _prod(cnf.stride_kv) > 1:
            self.pool_k = _TokenPool(hd, cnf.kernel_kv, cnf.stride_kv)
            self.pool_v = _TokenPool(hd, cnf.kernel_kv, cnf.stride_kv)
        else:
            self.pool_k = self.pool_v = None
        self.rel_pos_embed = rel_pos_embed
        if rel_pos_embed:
            size = max(input_size[1:])
            q_size = size // cnf.stride_q[1] if cnf.stride_q else size
            kv_size = size // cnf.stride_kv[1] if cnf.stride_kv else size
            spatial = 2 * max(q_size, kv_size) - 1
            self.rel_pos_h = nn.Parameter(torch.zeros(spatial, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(spatial, hd))
            self.rel_pos_t = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                      hd))

    def forward(self, x: torch.Tensor, thw: Thw):
        b, n, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                      self.head_dim).permute(2, 0, 3, 1, 4)
        k_thw = q_thw = thw
        if self.pool_k is not None:
            k, k_thw = self.pool_k(k, thw)
            v, _ = self.pool_v(v, thw)
        if self.pool_q is not None:
            q, q_thw = self.pool_q(q, thw)
        scaler = 1.0 / math.sqrt(self.head_dim)
        attn = torch.matmul((q * scaler).float(), k.float().transpose(-2, -1))
        if self.rel_pos_embed:
            attn = _add_rel_pos(attn, q, q_thw, k_thw, self.rel_pos_h,
                                self.rel_pos_w, self.rel_pos_t)
        attn = torch.softmax(attn, -1).to(v.dtype)
        out = torch.matmul(attn, v)
        if self.residual_pool:
            out = out + (q if self.residual_with_cls_embed
                         else F.pad(q[:, :, 1:], (0, 0, 1, 0)))
        out = out.transpose(1, 2).reshape(b, -1, self.output_dim)
        return self.project(out), q_thw


class MultiscaleBlock(nn.Module):
    def __init__(self, input_size: Thw, cnf: MSBlockConfig,
                 residual_pool: bool, residual_with_cls_embed: bool,
                 rel_pos_embed: bool, proj_after_attn: bool, sd_prob: float):
        super().__init__()
        self.proj_after_attn = proj_after_attn
        self.sd_prob = sd_prob
        attn_dim = (cnf.output_channels if proj_after_attn
                    else cnf.input_channels)
        self.norm1 = nn.LayerNorm(cnf.input_channels, eps=1e-6)
        self.attn = MultiscaleAttention(
            input_size, cnf.input_channels, attn_dim, cnf, residual_pool,
            residual_with_cls_embed, rel_pos_embed)
        self.norm2 = nn.LayerNorm(attn_dim, eps=1e-6)
        self.mlp = nn.Sequential(
            nn.Linear(attn_dim, 4 * attn_dim), nn.GELU(), nn.Dropout(0.0),
            nn.Linear(4 * attn_dim, cnf.output_channels))
        self.project = (nn.Linear(cnf.input_channels, cnf.output_channels)
                        if cnf.input_channels != cnf.output_channels else None)
        self.pool_skip = None
        if _prod(cnf.stride_q) > 1:
            kernel = [s + 1 if s > 1 else s for s in cnf.stride_q]
            self.pool_skip = _TokenPool(cnf.input_channels, kernel,
                                        cnf.stride_q, kind="max", norm=False)

    def forward(self, x: torch.Tensor, thw: Thw,
                generator: Optional[torch.Generator] = None):
        def sd(t):
            return stochastic_depth(t, self.sd_prob, "row", self.training,
                                    generator=generator)

        x_norm1 = self.norm1(x)
        x_attn, thw_new = self.attn(x_norm1, thw)
        if self.project is not None and self.proj_after_attn:
            x = self.project(x_norm1)
        x_skip = x if self.pool_skip is None else \
            self.pool_skip(x[:, None], thw)[0][:, 0]
        x = x_skip + sd(x_attn)
        x_norm2 = self.norm2(x)
        m = self.mlp(x_norm2)
        if self.project is not None and not self.proj_after_attn:
            x = self.project(x_norm2)
        return x + sd(m), thw_new


class _PositionalEncoding(nn.Module):
    def __init__(self, embed: int, thw: Thw, rel_pos_embed: bool):
        super().__init__()
        t, h, w = thw
        self.class_token = nn.Parameter(torch.zeros(embed))
        self.rel_pos_embed = rel_pos_embed
        if not rel_pos_embed:
            self.spatial_pos = nn.Parameter(torch.zeros(h * w, embed))
            self.temporal_pos = nn.Parameter(torch.zeros(t, embed))
            self.class_pos = nn.Parameter(torch.zeros(embed))

    def forward(self, x: torch.Tensor, thw: Thw) -> torch.Tensor:
        b, _, embed = x.shape
        x = torch.cat([self.class_token.expand(b, 1, embed), x], 1)
        if self.rel_pos_embed:
            return x
        t, h, w = thw
        pos = (self.temporal_pos.repeat_interleave(h * w, 0)
               + self.spatial_pos.repeat(t, 1))
        return x + torch.cat([self.class_pos[None], pos], 0)[None]


class MViT(nn.Module):
    """``forward(x, return_features=True)`` also returns each block's
    output under ``blocks.{i}``."""

    def __init__(self, block_setting: Sequence[MSBlockConfig],
                 spatial_size: Tuple[int, int] = (224, 224),
                 temporal_size: int = 16, residual_pool: bool = False,
                 residual_with_cls_embed: bool = False,
                 rel_pos_embed: bool = False, proj_after_attn: bool = False,
                 stochastic_depth_prob: float = 0.2, dropout: float = 0.5,
                 num_classes: int = 400):
        super().__init__()
        embed = block_setting[0].input_channels
        self.conv_proj = nn.Conv3d(3, embed, (3, 7, 7), (2, 4, 4), (1, 3, 3))
        size: Thw = tuple(s // st for s, st in zip(
            (temporal_size, *spatial_size), self.conv_proj.stride))
        self.pos_encoding = _PositionalEncoding(embed, size, rel_pos_embed)
        self.blocks = nn.ModuleList()
        total = len(block_setting)
        for i, cnf in enumerate(block_setting):
            sd = stochastic_depth_prob * i / (total - 1.0)
            self.blocks.append(MultiscaleBlock(
                size, cnf, residual_pool, residual_with_cls_embed,
                rel_pos_embed, proj_after_attn, sd))
            if len(cnf.stride_q) > 0:
                size = tuple(s // st for s, st in zip(size, cnf.stride_q))
        self.norm = nn.LayerNorm(block_setting[-1].output_channels, eps=1e-6)
        self.dropout = dropout
        self.head = nn.Sequential(
            nn.Dropout(dropout),
            nn.Linear(block_setting[-1].output_channels, num_classes))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.conv_proj(x)
        thw: Thw = tuple(x.shape[2:])
        x = self.pos_encoding(x.flatten(2).transpose(1, 2), thw)
        features: Dict[str, torch.Tensor] = {}
        for i, block in enumerate(self.blocks):
            x, thw = block(x, thw, generator)
            features[f"blocks.{i}"] = x
        x = self.norm(x)[:, 0]
        logits = self.head[1](_dropout(x, self.dropout, self.training,
                                       generator))
        if return_features:
            return logits, features
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torchvision's: Linears truncated normal of std 0.02 with zero bias,
    the positional and relative-position tables truncated normal of std
    0.02, convolutions PyTorch's default; norms identity."""
    init_norms(model)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
            m.bias.zero_()
        elif isinstance(m, nn.Conv3d):
            default_(m, generator)
    for name, p in model.named_parameters():
        if name.startswith("pos_encoding.") or ".rel_pos_" in name:
            trunc_normal_(p, 0.02, generator)


def _mk_config(config: Dict[str, list]) -> Tuple[MSBlockConfig, ...]:
    return tuple(MSBlockConfig(
        num_heads=config["num_heads"][i],
        input_channels=config["input_channels"][i],
        output_channels=config["output_channels"][i],
        kernel_q=tuple(config["kernel_q"][i]),
        kernel_kv=tuple(config["kernel_kv"][i]),
        stride_q=tuple(config["stride_q"][i]),
        stride_kv=tuple(config["stride_kv"][i]))
        for i in range(len(config["num_heads"])))


_HEADS = [1, 2, 2, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 8, 8]
_STRIDE_KV = [[1, 8, 8], [1, 4, 4], [1, 4, 4]] + [[1, 2, 2]] * 11 \
    + [[1, 1, 1]] * 2
_V1_CONFIG = {
    "num_heads": _HEADS,
    "input_channels": [96, 192, 192] + [384] * 11 + [768, 768],
    "output_channels": [192, 192] + [384] * 11 + [768] * 3,
    "kernel_q": [[], [3, 3, 3], [], [3, 3, 3]] + [[]] * 10
    + [[3, 3, 3], []],
    "kernel_kv": [[3, 3, 3]] * 16,
    "stride_q": [[], [1, 2, 2], [], [1, 2, 2]] + [[]] * 10
    + [[1, 2, 2], []],
    "stride_kv": _STRIDE_KV,
}
_V2_CONFIG = {
    "num_heads": _HEADS,
    "input_channels": [96, 96, 192, 192] + [384] * 11 + [768],
    "output_channels": [96, 192, 192] + [384] * 11 + [768, 768],
    "kernel_q": [[3, 3, 3]] * 16,
    "kernel_kv": [[3, 3, 3]] * 16,
    "stride_q": [[1, 1, 1], [1, 2, 2], [1, 1, 1], [1, 2, 2]]
    + [[1, 1, 1]] * 10 + [[1, 2, 2], [1, 1, 1]],
    "stride_kv": _STRIDE_KV,
}


class MViT_V1_B_Weights(WeightsEnum):
    KINETICS400_V1 = video_weights("mvit_v1_b-dbeb1030.pth", 78.477, 93.582,
                                   36610672, 70.599)
    DEFAULT = KINETICS400_V1


class MViT_V2_S_Weights(WeightsEnum):
    KINETICS400_V1 = video_weights("mvit_v2_s-ae3be167.pth", 80.757, 94.665,
                                   34537744, 64.224)
    DEFAULT = KINETICS400_V1


@register_model()
def mvit_v1_b(*, weights: Optional[MViT_V1_B_Weights] = None,
              device: Device = None, seed: int = 0, **kwargs: Any) -> MViT:
    weights = MViT_V1_B_Weights.verify(weights)
    return build(lambda: MViT(_mk_config(_V1_CONFIG), **kwargs), init_weights,
                 weights, device, seed)


@register_model()
def mvit_v2_s(*, weights: Optional[MViT_V2_S_Weights] = None,
              device: Device = None, seed: int = 0, **kwargs: Any) -> MViT:
    weights = MViT_V2_S_Weights.verify(weights)
    return build(lambda: MViT(
        _mk_config(_V2_CONFIG), residual_pool=True, rel_pos_embed=True,
        proj_after_attn=True, **kwargs), init_weights, weights, device, seed)
