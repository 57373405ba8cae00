"""Building blocks (counterpart of `tinyvc_tpu/models/layers.py`).

Parameter names and shapes follow PyTorch's habit (``weight [out, in, K]``)
under the JAX tree's module names, so `utils/weights.py` maps a flax tree
onto them with transposes only. The encoder and the SourceNet run
channels-last ``[B, T, C]`` as in JAX; the U-Net runs channels-first
``[B, C, T]``, the JAX package's ``filter_layout="cf"``.

``dtype`` is flax's computation dtype: parameters stay fp32 in the module
and are cast where flax casts them. With ``torch.bfloat16``, ``Dense``
casts input, kernel and bias to bf16 and computes in bf16 (the product
rounded to bf16, then the bias add); the depthwise conv takes bf16 operands
with an fp32 sum and bias; the norms take their statistics in fp32 and
return bf16 (`tinyvc_tpu/models/layers.py`, `flax/linen/linear.py`).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def replicate_pad_time(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Edge-pad the last axis of ``[B, C, T]``."""
    if left == 0 and right == 0:
        return x
    return F.pad(x, (left, right), mode="replicate")


BF16 = torch.bfloat16


def compute_dtype(name: str) -> torch.dtype:
    """A config's ``compute_dtype`` name -> the torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": BF16}
    if name not in dtypes:
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {name!r}")
    return dtypes[name]


class Dense(nn.Module):
    """Channels-last dense layer (flax ``nn.Dense``): ``x @ W.T + b``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == BF16:
            return torch.matmul(x.to(BF16), self.weight.to(BF16).T) + self.bias.to(BF16)
        return F.linear(x.to(self.dtype), self.weight, self.bias)  # flax casts the input


class Dense1x1CF(nn.Module):
    """1x1 conv on channels-first ``[B, C, T]`` with a dense layer's
    parameters (`layers.py::Dense1x1CF`)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == BF16:  # bf16 operands, fp32 sum and bias, bf16 out
            y = torch.matmul(self.weight.to(BF16).float(), x.to(BF16).float())
            return (y + self.bias[:, None]).to(BF16)
        return torch.matmul(self.weight, x) + self.bias[:, None]


class DepthwiseConv1d(nn.Module):
    """Depthwise conv along time of channels-last ``[B, T, C]`` with
    replicate padding."""

    def __init__(self, channels: int, kernel_size: int = 7, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.dilation, self.dtype = kernel_size, dilation, dtype
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (self.kernel_size * self.dilation - self.dilation) // 2
        w = self.weight
        if self.dtype == BF16:  # bf16 operands, fp32 sum and bias, bf16 out
            x, w = x.to(BF16).float(), w.to(BF16).float()
        x = replicate_pad_time(x.transpose(1, 2), pad, pad)
        y = F.conv1d(x, w, self.bias, dilation=self.dilation, groups=x.shape[1])
        return y.transpose(1, 2).to(self.dtype)


class Conv1d(nn.Module):
    """Full conv along time of channels-first ``[B, C, T]`` with replicate
    padding (`layers.py::Conv1d`, ``channels_first=True``)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.dilation, self.dtype = kernel_size, dilation, dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (self.kernel_size * self.dilation - self.dilation) // 2
        w = self.weight
        if self.dtype == BF16:  # bf16 operands, fp32 sum and bias, bf16 out
            x, w = x.to(BF16).float(), w.to(BF16).float()
        else:
            x = x.to(self.dtype)
        x = replicate_pad_time(x, pad, pad)
        return F.conv1d(x, w, self.bias, dilation=self.dilation).to(self.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the last (channel) axis, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()  # statistics in fp32
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta
        return y.to(self.dtype)


class GRN(nn.Module):
    """Global response normalisation over the time axis of ``[B, T, C]``:
    the statistic spans the whole utterance, padding included.

    For chunked conversion (`parallel/time_shard.py`), where the batch rows
    are overlapping time chunks of one utterance: ``time_halo`` frames at
    each end of a row are left out of the statistic, and with
    ``time_batch_reduce`` the statistic is summed over the rows, so every
    chunk sees the utterance's (`tinyvc_tpu/models/layers.py::GRN`); with
    ``time_group`` as well, a process group whose ranks hold the other
    rows, it is then summed over the group (JAX's ``psum`` over the time
    axis, `parallel/time_shard.py::time_sharded_convert`)."""

    def __init__(self, channels: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 time_halo: int = 0, time_batch_reduce: bool = False):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.time_halo, self.time_batch_reduce = time_halo, time_batch_reduce
        self.time_group = None
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()  # statistics in fp32
        h = self.time_halo
        core = x[..., h:x.shape[-2] - h, :] if h > 0 else x
        sq = torch.sum(core * core, dim=-2, keepdim=True)
        if self.time_batch_reduce:
            sq = torch.sum(sq, dim=0, keepdim=True)  # chunk rows -> the utterance
        if self.time_group is not None:
            dist.all_reduce(sq, group=self.time_group)  # every rank's rows
        gx = torch.sqrt(sq)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + self.eps)
        return (self.gamma * (x * nx) + self.beta + x).to(self.dtype)


@contextlib.contextmanager
def grn_time_chunks(module: nn.Module, time_halo: int, time_batch: bool, group=None):
    """Every :class:`GRN` under ``module`` takes ``time_halo``,
    ``time_batch_reduce`` = ``time_batch`` and ``time_group`` = ``group``
    for the duration, as if the module had been built with them; the
    settings it was built with come back afterwards. Lets one set of
    weights serve whole, chunked and time-sharded conversion. The settings
    live on the modules: a call on them from another thread meanwhile sees
    them too."""
    grns = [m for m in module.modules() if isinstance(m, GRN)]
    saved = [(m.time_halo, m.time_batch_reduce, m.time_group) for m in grns]
    for m in grns:
        m.time_halo, m.time_batch_reduce, m.time_group = time_halo, time_batch, group
    try:
        yield module
    finally:
        for m, (h, b, g) in zip(grns, saved):
            m.time_halo, m.time_batch_reduce, m.time_group = h, b, g


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its erf form (flax's default is the tanh approximation), in
    ``x``'s dtype."""
    if x.dtype == BF16:
        sh = torch.tensor(0.7071067811865476, dtype=BF16)
        return (0.5 * x) * torch.special.erfc(-x * sh)
    return F.gelu(x, approximate="none")


class ConvNeXtLayer(nn.Module):
    """ConvNeXt-v2 block: depthwise k=7 -> LN -> 1x1 (x2) -> GELU -> GRN ->
    1x1, plus the residual; every step in ``dtype``."""

    def __init__(self, channels: int, kernel_size: int = 7, mlp_mul: int = 2, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dw = DepthwiseConv1d(channels, kernel_size, dilation, dtype)
        self.norm = ChannelLayerNorm(channels, dtype=dtype)
        self.pw1 = Dense(channels, channels * mlp_mul, dtype)
        self.grn = GRN(channels * mlp_mul, dtype=dtype)
        self.pw2 = Dense(channels * mlp_mul, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.dw(x))
        y = self.grn(exact_gelu(self.pw1(y)))
        return self.pw2(y) + x


class ConvNeXtStack(nn.Module):
    """Input 1x1 -> LN -> ConvNeXt blocks -> output 1x1, every one of them in
    ``dtype`` (the JAX stack's ``dtype``)."""

    def __init__(self, in_features: int, channels: int, out_features: int,
                 dilations: Sequence[int], kernel_size: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_layer = Dense(in_features, channels, dtype)
        self.norm = ChannelLayerNorm(channels, dtype=dtype)
        for i, d in enumerate(dilations):
            self.add_module(f"layer_{i}",
                            ConvNeXtLayer(channels, kernel_size, dilation=d, dtype=dtype))
        self.num_layers = len(dilations)
        self.output_layer = Dense(channels, out_features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.input_layer(x))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.output_layer(x)


class FiLM(nn.Module):
    """Feature-wise linear modulation on channels-first tensors."""

    def __init__(self, channels: int, cond_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.to_scale = Dense1x1CF(cond_channels, channels, dtype)
        self.to_shift = Dense1x1CF(cond_channels, channels, dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return x * self.to_scale(cond) + self.to_shift(cond)
