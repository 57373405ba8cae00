"""Building blocks (counterpart of `tinyvc_tpu/models/layers.py`).

Parameter names and shapes follow PyTorch's habit (``weight [out, in, K]``)
under the JAX tree's module names, so `utils/weights.py` maps a flax tree
onto them with transposes only. The encoder and the SourceNet run
channels-last ``[B, T, C]`` as in JAX; the U-Net runs channels-first
``[B, C, T]``, the JAX package's ``filter_layout="cf"``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def replicate_pad_time(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Edge-pad the last axis of ``[B, C, T]``."""
    if left == 0 and right == 0:
        return x
    return F.pad(x, (left, right), mode="replicate")


class Dense(nn.Module):
    """Channels-last dense layer (flax ``nn.Dense``): ``x @ W.T + b``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Dense1x1CF(nn.Module):
    """1x1 conv on channels-first ``[B, C, T]`` with a dense layer's
    parameters (`layers.py::Dense1x1CF`)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.weight, x) + self.bias[:, None]


class DepthwiseConv1d(nn.Module):
    """Depthwise conv along time of channels-last ``[B, T, C]`` with
    replicate padding."""

    def __init__(self, channels: int, kernel_size: int = 7, dilation: int = 1):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (self.kernel_size * self.dilation - self.dilation) // 2
        x = replicate_pad_time(x.transpose(1, 2), pad, pad)
        y = F.conv1d(x, self.weight, self.bias, dilation=self.dilation, groups=x.shape[1])
        return y.transpose(1, 2)


class Conv1d(nn.Module):
    """Full conv along time of channels-first ``[B, C, T]`` with replicate
    padding (`layers.py::Conv1d`, ``channels_first=True``)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (self.kernel_size * self.dilation - self.dilation) // 2
        x = replicate_pad_time(x, pad, pad)
        return F.conv1d(x, self.weight, self.bias, dilation=self.dilation)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the last (channel) axis, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class GRN(nn.Module):
    """Global response normalisation over the time axis of ``[B, T, C]``:
    the statistic spans the whole utterance, padding included."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt(torch.sum(x * x, dim=-2, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + self.eps)
        return self.gamma * (x * nx) + self.beta + x


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its erf form (flax's default is the tanh approximation)."""
    return F.gelu(x, approximate="none")


class ConvNeXtLayer(nn.Module):
    """ConvNeXt-v2 block: depthwise k=7 -> LN -> 1x1 (x2) -> GELU -> GRN ->
    1x1, plus the residual."""

    def __init__(self, channels: int, kernel_size: int = 7, mlp_mul: int = 2, dilation: int = 1):
        super().__init__()
        self.dw = DepthwiseConv1d(channels, kernel_size, dilation)
        self.norm = ChannelLayerNorm(channels)
        self.pw1 = Dense(channels, channels * mlp_mul)
        self.grn = GRN(channels * mlp_mul)
        self.pw2 = Dense(channels * mlp_mul, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.dw(x))
        y = self.grn(exact_gelu(self.pw1(y)))
        return self.pw2(y) + x


class ConvNeXtStack(nn.Module):
    """Input 1x1 -> LN -> ConvNeXt blocks -> output 1x1."""

    def __init__(self, in_features: int, channels: int, out_features: int,
                 dilations: Sequence[int], kernel_size: int = 7):
        super().__init__()
        self.input_layer = Dense(in_features, channels)
        self.norm = ChannelLayerNorm(channels)
        for i, d in enumerate(dilations):
            self.add_module(f"layer_{i}", ConvNeXtLayer(channels, kernel_size, dilation=d))
        self.num_layers = len(dilations)
        self.output_layer = Dense(channels, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.input_layer(x))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.output_layer(x)


class FiLM(nn.Module):
    """Feature-wise linear modulation on channels-first tensors."""

    def __init__(self, channels: int, cond_channels: int):
        super().__init__()
        self.to_scale = Dense1x1CF(cond_channels, channels)
        self.to_shift = Dense1x1CF(cond_channels, channels)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return x * self.to_scale(cond) + self.to_shift(cond)
