"""Normalisation and building-block modules (counterpart of
``vision_tpu/ops/misc.py``): ``FrozenBatchNorm2d``; the live
``BatchNorm2d`` of the classification models, the v2 detectors' trunk,
FPN and heads (counterpart of ``flax.linen.BatchNorm`` as the JAX package
configures it, and of its ``_BNAffine``) and ``BatchNorm3d``; ``GroupNorm``
(counterpart of ``flax.linen.GroupNorm``, in RetinaNet's v2 head); and
torchvision's ``Conv2dNormActivation``, ``Conv3dNormActivation``,
``SqueezeExcitation``, ``MLP`` and ``Permute``, under torchvision's module
and state-dict names. Input NCHW (NCDHW for the 3-D modules)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["MLP", "BatchNorm2d", "BatchNorm3d", "Conv2dNormActivation",
           "Conv3dNormActivation", "FrozenBatchNorm2d", "GroupNorm", "Permute",
           "SqueezeExcitation", "batch_mean_var", "dropout"]


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d with fixed statistics and affine terms, all four held as
    buffers (not parameters), under torchvision's names. The folded scale
    is ``weight * rsqrt(running_var + eps)``, as the JAX ``_FrozenBN``
    computes it (``vision_tpu/models/detection/backbone_utils.py:47-48``).
    Input NCHW."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


def batch_mean_var(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of ``x`` (channels on dim 1:
    NC, NCHW, NCDHW) over every other dim, in f32, the variance as
    ``max(0, E[x^2] - E[x]^2)`` (flax's ``use_fast_variance``)."""
    xf = x.float()
    dims = (0, *range(2, x.ndim))
    mean = xf.mean(dims)
    var = ((xf * xf).mean(dims) - mean * mean).clamp_(min=0.0)
    return mean, var


class BatchNorm2d(nn.Module):
    """Batch norm over NCHW input (any input with its channels on dim 1)
    under ``torch.nn.BatchNorm2d``'s names
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``) with the arithmetic of ``flax.linen.BatchNorm``,
    which the JAX package uses and the port is held against:

    * the statistics are f32 whatever the input type, the variance is
      ``max(0, E[x^2] - E[x]^2)``;
    * ``running_var`` is updated with that BIASED variance.
      ``torch.nn.BatchNorm2d`` updates it with the unbiased one, a factor
      ``M / (M - 1)``, so it is not used here;
    * ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, cast
      to the promoted type of ``x``, ``weight`` and ``bias``.

    ``momentum`` follows torch's convention: 0.1 here is flax's 0.9.
    The running statistics are updated in place, outside autograd.
    ``use_running_average=True`` normalises by the running statistics in
    training mode too and never updates them (flax's
    ``use_running_average=True``: the JAX v2 detectors' FPN norm); its
    weight and bias still train.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, use_running_average: bool = False):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.use_running_average = use_running_average
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * var)
        self.num_batches_tracked += 1

    def affine_from_stats(
        self, mean: torch.Tensor, var: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """For batch statistics computed elsewhere (the fused 1x1-conv
        kernel's epilogue): update the running statistics when training and
        return f32 ``(inv, shift)`` with ``y_norm = y * inv + shift``
        (``vision_tpu/models/resnet.py:_BNAffine``)."""
        if self.training:
            self._track(mean, var)
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        return inv, self.bias.float() - mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and not self.use_running_average:
            mean, var = batch_mean_var(x)
            self._track(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.ndim - 2)  # per channel, broadcast
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - mean.view(shape)) * mul.view(shape)
        y = y + self.bias.float().view(shape)
        out_dtype = torch.promote_types(
            x.dtype, torch.promote_types(self.weight.dtype, self.bias.dtype))
        return y.to(out_dtype)


class GroupNorm(nn.Module):
    """Group norm over NCHW input under ``torch.nn.GroupNorm``'s names
    (``weight``, ``bias``) with the arithmetic of ``flax.linen.GroupNorm``:
    each group's mean and variance over (C / G, H, W) in f32, the variance
    as ``max(0, E[x^2] - E[x]^2)`` (``torch.nn.GroupNorm`` takes Welford's);
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, cast to
    the promoted type of ``x``, ``weight`` and ``bias``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{num_channels} channels")
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        xf = x.float().reshape(n, self.num_groups, -1)
        mean = xf.mean(-1)
        var = ((xf * xf).mean(-1) - mean * mean).clamp(min=0.0)
        size = c // self.num_groups  # the groups' statistics to channels
        mean = mean.repeat_interleave(size, 1)[..., None]
        mul = torch.rsqrt(var + self.eps).repeat_interleave(size, 1)
        mul = (mul * self.weight.float())[..., None]
        y = (xf.reshape(n, c, -1) - mean) * mul + self.bias.float()[:, None]
        out_dtype = torch.promote_types(
            x.dtype, torch.promote_types(self.weight.dtype, self.bias.dtype))
        return y.reshape(x.shape).to(out_dtype)


class BatchNorm3d(BatchNorm2d):
    """``BatchNorm2d`` over NCDHW input (``torch.nn.BatchNorm3d``'s
    place)."""


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator``."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator: "
                         "forward(x, generator=...)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def _ntuple(v, n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNormActivation(nn.Sequential):
    """A convolution, a norm and an activation as torchvision's
    ``Conv2dNormActivation`` builds them: children ``0`` (the convolution,
    biased only where there is no norm unless ``bias`` says otherwise),
    ``1`` (``norm_layer(out_channels)``, when given) and the activation
    (``activation_layer(inplace=inplace)``, or with no argument where
    ``inplace`` is None). ``padding=None`` keeps the size at stride 1:
    ``(kernel_size - 1) // 2 * dilation`` a side."""

    def __init__(self, conv: Callable[..., nn.Module], dims: int,
                 in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, padding=None, groups: int = 1,
                 norm_layer: Optional[Callable[..., nn.Module]] = None,
                 activation_layer: Optional[Callable[..., nn.Module]] = nn.ReLU,
                 dilation=1, inplace: Optional[bool] = True,
                 bias: Optional[bool] = None):
        ks, dil = _ntuple(kernel_size, dims), _ntuple(dilation, dims)
        if padding is None:
            padding = tuple((k - 1) // 2 * d for k, d in zip(ks, dil))
        if bias is None:
            bias = norm_layer is None
        layers: List[nn.Module] = [conv(
            in_channels, out_channels, ks, stride, padding, dilation=dil,
            groups=groups, bias=bias)]
        if norm_layer is not None:
            layers.append(norm_layer(out_channels))
        if activation_layer is not None:
            layers.append(activation_layer() if inplace is None
                          else activation_layer(inplace=inplace))
        super().__init__(*layers)
        self.out_channels = out_channels


class Conv2dNormActivation(_ConvNormActivation):
    """Conv2d, norm (the port's ``BatchNorm2d`` by default, flax's
    arithmetic), activation (``nn.ReLU``): torchvision's module and names
    (``0.weight``, ``1.running_mean``, ...), the JAX package's
    ``Conv2dNormActivation``. Input NCHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, padding=None, groups: int = 1,
                 norm_layer: Optional[Callable[..., nn.Module]] = BatchNorm2d,
                 activation_layer: Optional[Callable[..., nn.Module]] = nn.ReLU,
                 dilation=1, inplace: Optional[bool] = True,
                 bias: Optional[bool] = None):
        super().__init__(nn.Conv2d, 2, in_channels, out_channels, kernel_size,
                         stride, padding, groups, norm_layer, activation_layer,
                         dilation, inplace, bias)


class Conv3dNormActivation(_ConvNormActivation):
    """The 3-D ``Conv2dNormActivation`` (norm ``BatchNorm3d``), input
    NCDHW. The JAX module pads for ``dilation`` but leaves its
    convolution undilated; this one dilates it, as torchvision's does (the
    two agree at ``dilation=1``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, padding=None, groups: int = 1,
                 norm_layer: Optional[Callable[..., nn.Module]] = BatchNorm3d,
                 activation_layer: Optional[Callable[..., nn.Module]] = nn.ReLU,
                 dilation=1, inplace: Optional[bool] = True,
                 bias: Optional[bool] = None):
        super().__init__(nn.Conv3d, 3, in_channels, out_channels, kernel_size,
                         stride, padding, groups, norm_layer, activation_layer,
                         dilation, inplace, bias)


class SqueezeExcitation(nn.Module):
    """Squeeze-and-excitation: the spatial mean of NCHW ``x``, 1x1
    convolutions ``fc1`` and ``fc2`` with ``activation`` between them and
    ``scale_activation`` after, and ``x`` scaled by the result per
    channel."""

    def __init__(self, input_channels: int, squeeze_channels: int,
                 activation: Callable[..., nn.Module] = nn.ReLU,
                 scale_activation: Callable[..., nn.Module] = nn.Sigmoid):
        super().__init__()
        self.fc1 = nn.Conv2d(input_channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, input_channels, 1)
        self.activation = activation()
        self.scale_activation = scale_activation()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.mean((-2, -1), keepdim=True)
        scale = self.scale_activation(self.fc2(self.activation(self.fc1(scale))))
        return x * scale


class MLP(nn.Sequential):
    """Linear layers over the last dim, torchvision's ``MLP`` and names:
    for each hidden size but the last, ``Linear``, ``norm_layer(size)``
    (when given), the activation and a dropout; then the last ``Linear``
    and a dropout. The dropouts draw from ``forward(x, generator=g)`` in
    training mode (``dropout`` > 0). ``jax_names`` maps the JAX module's
    child names (``"0"``, ``"2"``, ``"4"``, ... for the Dense layers,
    ``"norm{i}"`` for the norms) to these, for ``load_jax_variables``."""

    def __init__(self, in_channels: int, hidden_channels: Sequence[int],
                 norm_layer: Optional[Callable[..., nn.Module]] = None,
                 activation_layer: Optional[Callable[..., nn.Module]] = nn.ReLU,
                 inplace: Optional[bool] = None, bias: bool = True,
                 dropout: float = 0.0):
        layers: List[nn.Module] = []
        self_jax: Dict[str, str] = {}
        prev = in_channels
        for i, hidden in enumerate(hidden_channels):
            self_jax[str(2 * i)] = str(len(layers))
            layers.append(nn.Linear(prev, hidden, bias=bias))
            if i < len(hidden_channels) - 1:
                if norm_layer is not None:
                    self_jax[f"norm{i}"] = str(len(layers))
                    layers.append(norm_layer(hidden))
                if activation_layer is not None:
                    layers.append(activation_layer() if inplace is None
                                  else activation_layer(inplace=inplace))
            layers.append(nn.Dropout(dropout))
            prev = hidden
        super().__init__(*layers)
        self.jax_names = self_jax

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, nn.Dropout):
                x = dropout(x, layer.p, self.training, generator)
            else:
                x = layer(x)
        return x


class Permute(nn.Module):
    """``torch.permute`` of the input by ``dims``, as a module."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = list(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.permute(x, self.dims)
