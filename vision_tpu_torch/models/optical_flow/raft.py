"""RAFT optical flow (counterpart of
``vision_tpu/models/optical_flow/raft.py``): raft_large, raft_small.

NCHW input, two images in [-1, 1] (the ``OpticalFlow`` preset);
``forward(image1, image2, num_flow_updates=None)`` returns the list of
``[N, 2, H, W]`` flow predictions, one an update. Module and state-dict
names are torchvision's (``feature_encoder``, ``context_encoder``,
``update_block.motion_encoder`` / ``.recurrent_block.convgru{1,2}`` /
``.flow_head``, ``mask_predictor``); the instance norms have no
parameters, as torchvision's ``InstanceNorm2d(affine=False)`` has none.

The correlation volume is ``fmap1^T fmap2 / sqrt(C)`` per image, f32
for bf16 features too (widened, as the JAX product's
``preferred_element_type`` does; f64 for f64), pooled into a pyramid by 2x2
means that floor odd sizes. The lookup samples each query's 9x9 window
(7x7 for raft_small) with ``grid_sample(align_corners=True,
padding=zeros)`` semantics, as two batched contractions with per-axis
tap weights, the JAX package's formulation and summation order; the
channel order is x-major. ``coords1`` is detached at the start of every
update.

Every convolution computes in the promoted type of its input and its
weights, as flax promotes: in a bf16 model the volume, the lookup and the
coordinates are f32, so the update block and the mask predictor run in f32
from the first update on, and only the encoders compute in bf16.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import Weights, WeightsEnum, register_model
from vision_tpu_torch.models._utils import (
    Device,
    build,
    default_,
    fan_out_normal_,
    init_norms,
    zero_bias_,
)
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.transforms._presets import OpticalFlow
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = [
    "RAFT",
    "CorrBlock",
    "Raft_Large_Weights",
    "Raft_Small_Weights",
    "raft_large",
    "raft_small",
    "upsample_flow",
]


class _Conv(nn.Conv2d):
    """A convolution in the promoted type of its input and its weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class _InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over (H, W), no parameters,
    eps 1e-5, with flax ``GroupNorm``'s arithmetic: the statistics in f32,
    the variance as ``max(0, E[x^2] - E[x]^2)``, the result in the input's
    type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean((-2, -1), keepdim=True)
        var = ((xf * xf).mean((-2, -1), keepdim=True) - mean * mean).clamp(
            min=0.0)
        return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


class _CNA(nn.Sequential):
    """Conv (with bias, as in RAFT), an optional norm (``"instance"``,
    ``"batch"`` or None) and an optional ReLU: children ``0``, ``1``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 norm: Optional[str] = "instance", act: bool = True):
        layers: List[nn.Module] = [_Conv(cin, cout, kernel, stride,
                                         (kernel - 1) // 2)]
        if norm == "instance":
            layers.append(_InstanceNorm())
        elif norm == "batch":
            layers.append(BatchNorm2d(cout))
        elif norm is not None:
            raise ValueError(f"norm {norm!r}")
        if act:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 norm: Optional[str] = "instance"):
        super().__init__()
        self.convnormrelu1 = _CNA(cin, cout, 3, stride, norm)
        self.convnormrelu2 = _CNA(cout, cout, 3, 1, norm)
        self.downsample = (_CNA(cin, cout, 1, stride, norm, act=False)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convnormrelu2(self.convnormrelu1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 norm: Optional[str] = "instance"):
        super().__init__()
        self.convnormrelu1 = _CNA(cin, cout // 4, 1, 1, norm)
        self.convnormrelu2 = _CNA(cout // 4, cout // 4, 3, stride, norm)
        self.convnormrelu3 = _CNA(cout // 4, cout, 1, 1, norm)
        self.downsample = (_CNA(cin, cout, 1, stride, norm, act=False)
                           if stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convnormrelu3(self.convnormrelu2(self.convnormrelu1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class FeatureEncoder(nn.Module):
    """A 7x7 stride-2 stem, three stages of two blocks (strides 1, 2, 2),
    a 1x1 convolution: output stride 8."""

    def __init__(self, layers: Sequence[int] = (64, 64, 96, 128, 256),
                 norm: Optional[str] = "instance", block: str = "residual"):
        super().__init__()
        blk = ResidualBlock if block == "residual" else BottleneckBlock
        self.convnormrelu = _CNA(3, layers[0], 7, 2, norm)
        for i, stride in enumerate((1, 2, 2), start=1):
            self.add_module(f"layer{i}", nn.Sequential(
                blk(layers[i - 1], layers[i], stride, norm),
                blk(layers[i], layers[i], 1, norm)))
        self.conv = _Conv(layers[3], layers[4], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convnormrelu(x)
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv(x)


class MotionEncoder(nn.Module):
    def __init__(self, in_channels_corr: int,
                 corr_layers: Sequence[int] = (256, 192),
                 flow_layers: Sequence[int] = (128, 64),
                 out_channels: int = 128):
        super().__init__()
        self.convcorr1 = _CNA(in_channels_corr, corr_layers[0], 1, norm=None)
        self.convcorr2 = (_CNA(corr_layers[0], corr_layers[1], 3, norm=None)
                          if len(corr_layers) == 2 else None)
        self.convflow1 = _CNA(2, flow_layers[0], 7, norm=None)
        self.convflow2 = _CNA(flow_layers[0], flow_layers[1], 3, norm=None)
        self.conv = _CNA(corr_layers[-1] + flow_layers[1], out_channels - 2, 3,
                         norm=None)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        corr = self.convcorr1(corr)
        if self.convcorr2 is not None:
            corr = self.convcorr2(corr)
        f = self.convflow2(self.convflow1(flow))
        return torch.cat([self.conv(torch.cat([corr, f], 1)), flow], 1)


class ConvGRU(nn.Module):
    def __init__(self, input_size: int, hidden_size: int,
                 kernel: Tuple[int, int]):
        super().__init__()
        pad = ((kernel[0] - 1) // 2, (kernel[1] - 1) // 2)
        cin = hidden_size + input_size
        self.convz = _Conv(cin, hidden_size, kernel, padding=pad)
        self.convr = _Conv(cin, hidden_size, kernel, padding=pad)
        self.convq = _Conv(cin, hidden_size, kernel, padding=pad)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class _Recurrent(nn.Module):
    """``convgru1`` (and ``convgru2`` where there are two kernels)."""

    def __init__(self, input_size: int, hidden_size: int,
                 kernels: Sequence[Tuple[int, int]]):
        super().__init__()
        for i, k in enumerate(kernels, start=1):
            self.add_module(f"convgru{i}", ConvGRU(input_size, hidden_size,
                                                   tuple(k)))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for gru in self.children():
            h = gru(h, x)
        return h


class _FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.conv1 = _Conv(cin, hidden, 3, padding=1)
        self.conv2 = _Conv(hidden, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    """Motion encoder, the ConvGRU(s) over [context, motion], flow head."""

    def __init__(self, in_channels_corr: int, hidden_state_size: int = 128,
                 context_size: int = 128,
                 corr_layers: Sequence[int] = (256, 192),
                 flow_layers: Sequence[int] = (128, 64),
                 motion_out: int = 128,
                 gru_kernels: Sequence[Tuple[int, int]] = ((1, 5), (5, 1)),
                 flow_head_hidden: int = 256):
        super().__init__()
        self.motion_encoder = MotionEncoder(in_channels_corr, corr_layers,
                                            flow_layers, motion_out)
        self.recurrent_block = _Recurrent(context_size + motion_out,
                                          hidden_state_size, gru_kernels)
        self.flow_head = _FlowHead(hidden_state_size, flow_head_hidden)

    def forward(self, hidden_state, context, corr_features, flow):
        motion = self.motion_encoder(flow, corr_features)
        h = self.recurrent_block(hidden_state, torch.cat([context, motion], 1))
        return h, self.flow_head(h)


class MaskPredictor(nn.Module):
    """The convex-upsampling weights: 3x3 conv, ReLU, 1x1 to 8*8*9, times
    0.25."""

    def __init__(self, cin: int, hidden_size: int = 256,
                 multiplier: float = 0.25):
        super().__init__()
        self.convrelu = _CNA(cin, hidden_size, 3, norm=None)
        self.conv = _Conv(hidden_size, 8 * 8 * 9, 1)
        self.multiplier = multiplier

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.multiplier * self.conv(self.convrelu(x))


def _axis_tap_weights(centers: torch.Tensor, deltas: torch.Tensor,
                      size: int) -> torch.Tensor:
    """``[Q, S, size]`` bilinear tap weights along one axis for the sample
    points ``centers[q] + deltas[s]``: ``1 - frac`` on ``floor(c)`` and
    ``frac`` on ``floor(c) + 1``, a tap outside ``[0, size)`` weighing
    nothing (``grid_sample(align_corners=True, padding=zeros)``)."""
    c = centers[:, None] + deltas[None, :]
    lo = torch.floor(c)
    frac = c - lo
    lo = lo.long()
    grid = torch.arange(size, device=c.device)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    w_lo = torch.where((lo >= 0) & (lo < size), 1.0 - frac, zero)
    w_hi = torch.where((lo + 1 >= 0) & (lo + 1 < size), frac, zero)
    w = (grid == lo.clamp(0, size - 1)[..., None]).to(c.dtype) * w_lo[..., None]
    return w + (grid == (lo + 1).clamp(0, size - 1)[..., None]).to(c.dtype) \
        * w_hi[..., None]


class CorrBlock:
    """The all-pairs correlation pyramid and its windowed lookup."""

    def __init__(self, num_levels: int = 4, radius: int = 4):
        self.num_levels = num_levels
        self.radius = radius
        self.out_channels = num_levels * (2 * radius + 1) ** 2

    def build_pyramid(self, fmap1: torch.Tensor, fmap2: torch.Tensor
                      ) -> List[torch.Tensor]:
        """``[N, C, H, W]`` maps -> ``num_levels`` f32 volumes ``[N*H*W,
        h_l, w_l]``, each query's correlation plane."""
        b, c, h, w = fmap1.shape
        dt = torch.promote_types(fmap1.dtype, torch.float32)
        f1 = fmap1.to(dt).reshape(b, c, h * w)
        f2 = fmap2.to(dt).reshape(b, c, h * w)
        corr = torch.matmul(f1.transpose(1, 2), f2) / math.sqrt(c)
        vol = corr.reshape(b * h * w, 1, h, w)
        pyramid = [vol[:, 0]]
        for _ in range(self.num_levels - 1):
            vol = F.avg_pool2d(vol, 2, 2)
            pyramid.append(vol[:, 0])
        return pyramid

    def index_pyramid(self, pyramid: Sequence[torch.Tensor],
                      coords: torch.Tensor) -> torch.Tensor:
        """``coords [N, 2, H, W]`` absolute (x, y) -> ``[N, out_channels,
        H, W]``: each level's window, channel ``i * side + j`` for x offset
        ``i`` and y offset ``j``."""
        r = self.radius
        side = 2 * r + 1
        b, _, h, w = coords.shape
        c = coords.permute(0, 2, 3, 1).reshape(b * h * w, 2)
        cx, cy = c[:, 0], c[:, 1]
        d = torch.linspace(-r, r, side, dtype=c.dtype, device=c.device)
        feats = []
        for vol in pyramid:
            wy = _axis_tap_weights(cy, d, vol.shape[1])  # [Q, side, h_l]
            wx = _axis_tap_weights(cx, d, vol.shape[2])  # [Q, side, w_l]
            tmp = torch.bmm(wy, vol)  # [Q, j, x]
            sampled = torch.bmm(wx, tmp.transpose(1, 2))  # [Q, i, j]
            feats.append(sampled.reshape(b, h, w, side * side))
            cx, cy = cx / 2, cy / 2
        return torch.cat(feats, -1).permute(0, 3, 1, 2)


def upsample_flow(flow: torch.Tensor, up_mask: Optional[torch.Tensor] = None,
                  factor: int = 8) -> torch.Tensor:
    """``[N, 2, h, w]`` -> ``[N, 2, factor*h, factor*w]``: with ``up_mask``
    (``[N, 9*factor^2, h, w]``) the convex combination of each 3x3
    neighbourhood of ``factor * flow`` (zero padded), softmax weights over
    the 9; without, ``factor *`` a bilinear resize with aligned corners."""
    b, ch, h, w = flow.shape
    if up_mask is None:
        return factor * resize_2d(flow, (h * factor, w * factor),
                                  mode="bilinear", antialias=False,
                                  align_corners=True)
    mask = torch.softmax(up_mask.reshape(b, 1, 9, factor, factor, h, w), 2)
    neigh = F.unfold(factor * flow, 3, padding=1)
    neigh = neigh.reshape(b, ch, 9, 1, 1, h, w)
    up = (mask * neigh).sum(2)  # [N, 2, factor, factor, h, w]
    up = up.permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, ch, h * factor, w * factor)


class RAFT(nn.Module):
    def __init__(self, num_flow_updates: int = 12,
                 use_mask_predictor: bool = True,
                 feature_layers: Sequence[int] = (64, 64, 96, 128, 256),
                 context_layers: Sequence[int] = (64, 64, 96, 128, 256),
                 encoder_block: str = "residual",
                 context_norm: Optional[str] = "batch", corr_radius: int = 4,
                 hidden_state_size: int = 128,
                 corr_layers: Sequence[int] = (256, 192),
                 flow_layers: Sequence[int] = (128, 64), motion_out: int = 128,
                 gru_kernels: Sequence[Tuple[int, int]] = ((1, 5), (5, 1)),
                 flow_head_hidden: int = 256):
        super().__init__()
        self.num_flow_updates = num_flow_updates
        self.hidden_state_size = hidden_state_size
        self.feature_encoder = FeatureEncoder(feature_layers, "instance",
                                              encoder_block)
        self.context_encoder = FeatureEncoder(context_layers, context_norm,
                                              encoder_block)
        self.corr_block = CorrBlock(radius=corr_radius)
        self.update_block = UpdateBlock(
            self.corr_block.out_channels, hidden_state_size,
            context_layers[-1] - hidden_state_size, corr_layers, flow_layers,
            motion_out, gru_kernels, flow_head_hidden)
        self.mask_predictor = (MaskPredictor(hidden_state_size)
                               if use_mask_predictor else None)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                num_flow_updates: Optional[int] = None) -> List[torch.Tensor]:
        n_updates = num_flow_updates or self.num_flow_updates
        b = image1.shape[0]
        fmaps = self.feature_encoder(torch.cat([image1, image2], 0))
        pyramid = self.corr_block.build_pyramid(fmaps[:b], fmaps[b:])

        context_out = self.context_encoder(image1)
        hidden = torch.tanh(context_out[:, :self.hidden_state_size])
        context = F.relu(context_out[:, self.hidden_state_size:])

        h8, w8 = fmaps.shape[-2:]
        dt = torch.promote_types(image1.dtype, torch.float32)
        ys, xs = torch.meshgrid(
            torch.arange(h8, dtype=dt, device=image1.device),
            torch.arange(w8, dtype=dt, device=image1.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys])[None].expand(b, 2, h8, w8)
        coords1 = coords0
        predictions = []
        for _ in range(n_updates):
            coords1 = coords1.detach()
            corr = self.corr_block.index_pyramid(pyramid, coords1)
            hidden, delta = self.update_block(hidden, context, corr,
                                              coords1 - coords0)
            coords1 = coords1 + delta
            mask = (None if self.mask_predictor is None
                    else self.mask_predictor(hidden))
            predictions.append(upsample_flow(coords1 - coords0, mask))
        return predictions


@torch.no_grad()
def init_weights(model: RAFT, generator: torch.Generator) -> None:
    """torchvision's: the encoders' convolutions He-normal over the fan out
    with zero bias, norms identity; the update block's and the mask
    predictor's PyTorch's default."""
    init_norms(model)
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            if name.startswith(("feature_encoder.", "context_encoder.")):
                fan_out_normal_(m.weight, generator)
                zero_bias_(m)
            else:
                default_(m, generator)


_URL = "https://download.pytorch.org/models/"


def _w(file: str, epe_clean: Optional[float], epe_final: Optional[float],
       num_params: int, ops: float) -> Weights:
    return Weights(url=_URL + file, transforms=OpticalFlow, meta={
        "num_params": num_params, "_ops": ops,
        "_metrics": {"Sintel-Train-Cleanpass": {"epe": epe_clean},
                     "Sintel-Train-Finalpass": {"epe": epe_final}},
    })


class Raft_Large_Weights(WeightsEnum):
    C_T_V1 = _w("raft_large_C_T_V1-22a6c225.pth", 1.4411, 2.7894, 5257536,
                211.007)
    C_T_V2 = _w("raft_large_C_T_V2-1bb1363a.pth", 1.3822, 2.7161, 5257536,
                211.007)
    C_T_SKHT_V1 = _w("raft_large_C_T_SKHT_V1-0b8c9e55.pth", None, None,
                     5257536, 211.007)
    C_T_SKHT_V2 = _w("raft_large_C_T_SKHT_V2-ff5fadd5.pth", None, None,
                     5257536, 211.007)
    DEFAULT = C_T_SKHT_V2


class Raft_Small_Weights(WeightsEnum):
    C_T_V1 = _w("raft_small_C_T_V1-ad48884c.pth", 2.1231, 3.2790, 990162,
                47.655)
    C_T_V2 = _w("raft_small_C_T_V2-01064c6d.pth", 1.9901, 3.2831, 990162,
                47.655)
    DEFAULT = C_T_V2


_SMALL = dict(use_mask_predictor=False, feature_layers=(32, 32, 64, 96, 128),
              context_layers=(32, 32, 64, 96, 160), encoder_block="bottleneck",
              context_norm=None, corr_radius=3, hidden_state_size=96,
              corr_layers=(96,), flow_layers=(64, 32), motion_out=82,
              gru_kernels=((3, 3),), flow_head_hidden=128)


@register_model()
def raft_large(*, weights: Optional[Raft_Large_Weights] = None,
               device: Device = None, seed: int = 0, **kwargs: Any) -> RAFT:
    weights = Raft_Large_Weights.verify(weights)
    return build(lambda: RAFT(**kwargs), init_weights, weights, device, seed)


@register_model()
def raft_small(*, weights: Optional[Raft_Small_Weights] = None,
               device: Device = None, seed: int = 0, **kwargs: Any) -> RAFT:
    weights = Raft_Small_Weights.verify(weights)
    return build(lambda: RAFT(**{**_SMALL, **kwargs}), init_weights, weights,
                 device, seed)
