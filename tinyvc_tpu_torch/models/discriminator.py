"""HiFi-GAN-style discriminators: multi-period (MPD) and multi-resolution
(MRD) (counterpart of `tinyvc_tpu/models/discriminator.py`).

Every conv is weight-normalised with explicit parameters under the JAX
tree's names: ``v`` in flax's HWIO layout ``[kh, kw, cin, cout]``, ``g``
``[cout]`` and ``bias``; the effective weight is ``v / sqrt(sum(v^2) +
1e-12) * g`` per output channel, the ``1e-12`` inside the square root as JAX
writes it (torch's ``weight_norm`` has no such term). The convs run NCHW
through ``F.conv2d``, as the JAX package computes them outside any Pallas
kernel; ``compute_dtype`` casts only the conv's operands and bias.

The reference's MRD computes a leaky ReLU and drops it, so its conv stack is
linear; ``DiscriminatorConfig.mrd_fixed_activation`` (default False) keeps
that, True applies the activation.

``mrd_conv_impl``: JAX's "lax", "hybrid", "nhwc", "unfold" and "xres" are
TPU layout lowerings of one function whose feature maps match "lax"
exactly; the port runs each of them as the NCHW conv form. "fused" runs the
phase-plane chain (`ops/mrd_planes.py`) through `kernels/mrd.py` (kernels M,
N, O on CUDA tensors) and returns its outputs flat plane-major
``[B, c, s_out*(g_out+4)*Wp]`` with zeros off the valid positions; the
losses then divide by :func:`fused_mrd_valid_counts`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DiscriminatorConfig
from ..dsp.stft import stft_magnitude
from ..kernels.mrd import mrd_chain
from ..ops.mrd_planes import make_plan, pack_spec_planes

MRD_IMPLS = ("lax", "hybrid", "nhwc", "unfold", "xres", "fused")


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class WNConv2d(nn.Module):
    """Conv2d with weight normalisation (`discriminator.py:29-136`); ``pad_mode``
    "replicate" edge-pads and convolves without padding."""

    def __init__(self, cin: int, cout: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0),
                 pad_mode: str = "zeros", compute_dtype: str = "float32"):
        super().__init__()
        kh, kw = kernel_size
        self.strides, self.padding, self.pad_mode = tuple(strides), tuple(padding), pad_mode
        self.dtype = _dtype(compute_dtype)
        self.v = nn.Parameter(torch.zeros(kh, kw, cin, cout))
        self.g = nn.Parameter(torch.zeros(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def effective_weight(self) -> torch.Tensor:
        """The weight-normalised HWIO kernel (`WNConv2dWeights`, fp32)."""
        norm = torch.sqrt(torch.sum(self.v * self.v, dim=(0, 1, 2), keepdim=True) + 1e-12)
        return self.v / norm * self.g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight().permute(3, 2, 0, 1)  # OIHW
        bias = self.bias
        if self.dtype != torch.float32:
            x, w, bias = x.to(self.dtype), w.to(self.dtype), bias.to(self.dtype)
        ph, pw = self.padding
        if self.pad_mode == "replicate" and (ph or pw):
            x = F.pad(x, (pw, pw, ph, ph), mode="replicate")
            ph = pw = 0
        y = F.conv2d(x, w, stride=self.strides, padding=(ph, pw))
        return y + bias[None, :, None, None]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class DiscriminatorP(nn.Module):
    """Period-folded 2D conv discriminator (`discriminator.py:216-254`)."""

    def __init__(self, period: int, channels: int = 32, channels_mul: int = 2,
                 max_channels: int = 256, num_layers: int = 4, compute_dtype: str = "float32"):
        super().__init__()
        self.period = period
        self.num_layers = num_layers
        c = channels
        self.conv_0 = WNConv2d(1, c, (5, 1), (3, 1), (2, 0), "replicate", compute_dtype)
        for i in range(num_layers):
            nxt = min(c * channels_mul, max_channels)
            setattr(self, f"conv_{i + 1}",
                    WNConv2d(c, nxt, (5, 1), (3, 1), (2, 0), "replicate", compute_dtype))
            c = nxt
        self.post = WNConv2d(c, 1, (3, 1), (1, 1), (1, 0), "replicate", compute_dtype)

    def forward(self, x: torch.Tensor):
        """``[B, T]`` -> (logits, feature maps)."""
        B, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x[:, None], (0, p - T % p), mode="reflect")[:, 0]
            T = x.shape[1]
        h = x.reshape(B, 1, T // p, p)
        fmap: List[torch.Tensor] = []
        for i in range(self.num_layers + 1):
            h = _lrelu(getattr(self, f"conv_{i}")(h))
            fmap.append(h)
        h = self.post(h)
        fmap.append(h)
        return h, fmap


class DiscriminatorR(nn.Module):
    """STFT-magnitude 2D conv discriminator (`discriminator.py:257-357`)."""

    def __init__(self, resolution: int, channels: int = 32, max_channels: int = 256,
                 num_layers: int = 4, fixed_activation: bool = False,
                 compute_dtype: str = "float32", conv_impl: str = "lax"):
        super().__init__()
        if conv_impl not in MRD_IMPLS:
            raise ValueError(f"mrd_conv_impl must be one of {MRD_IMPLS}, got {conv_impl!r}")
        self.resolution, self.channels, self.max_channels = resolution, channels, max_channels
        self.num_layers, self.fixed_activation = num_layers, fixed_activation
        self.conv_impl = conv_impl
        c = channels
        self.conv_0 = WNConv2d(1, c, (7, 3), (2, 1), (3, 1), compute_dtype=compute_dtype)
        for i in range(num_layers):
            nxt = min(c * 2, max_channels)
            setattr(self, f"conv_{i + 1}",
                    WNConv2d(c, nxt, (5, 3), (2, 1), (2, 1), compute_dtype=compute_dtype))
            c = nxt
        self.post = WNConv2d(c, 1, (3, 3), (1, 1), (1, 1), compute_dtype=compute_dtype)

    def convs(self) -> List[WNConv2d]:
        return [getattr(self, f"conv_{i}") for i in range(self.num_layers + 1)] + [self.post]

    def forward(self, x: torch.Tensor, dtype_name: Optional[str] = None):
        """``[B, T]`` -> (logits, feature maps); ``dtype_name`` is the fused
        chain's operand dtype (default: bf16 on CUDA, fp32 on the CPU)."""
        # fp32 spectrogram with frame 0 kept: [B, frames, bins]
        spec = stft_magnitude(x, self.resolution * 4, self.resolution, drop_first=False,
                              grad_safe=True)
        if self.conv_impl == "fused":
            return self._fused(spec, x.shape[-1], dtype_name)
        h = spec.transpose(1, 2)[:, None]  # [B, 1, bins, frames]
        fmap: List[torch.Tensor] = []
        for conv in self.convs()[:-1]:
            h = conv(h)
            if self.fixed_activation:
                h = _lrelu(h)
            fmap.append(h)
        h = self.post(h)
        fmap.append(h)
        return h, fmap

    def _fused(self, spec: torch.Tensor, T: int, dtype_name: Optional[str]):
        """The conv stack through `kernels/mrd.py::mrd_chain`; the outputs
        flat plane-major (`discriminator.py:322-357`)."""
        if self.fixed_activation:
            raise ValueError("mrd_conv_impl='fused' supports the faithful (activation-free) "
                             "MRD only; use 'lax' with mrd_fixed_activation=True")
        plan = make_plan(self.resolution, T, self.channels, self.max_channels, self.num_layers)
        spec_pm = pack_spec_planes(spec.transpose(1, 2), plan)
        if dtype_name is None:
            dtype_name = "bfloat16" if spec.device.type == "cuda" else "float32"
        convs = self.convs()
        outs = mrd_chain(spec_pm, [c.effective_weight() for c in convs],
                         [c.bias for c in convs], plan, dtype_name)
        return outs[-1], outs


def fused_mrd_valid_counts(cfg: DiscriminatorConfig, T: int):
    """(logit_counts, fmap_counts) aligned with :class:`Discriminator`'s
    output lists under ``mrd_conv_impl="fused"``: None for the MPD's dense
    maps, the plane-major valid-position counts for the MRD's
    (`discriminator.py:497-516`). ``T``: the waveform length (the crop)."""
    logit_counts: List[Optional[int]] = []
    fmap_counts: List[Optional[int]] = []
    for _ in cfg.periods:
        logit_counts.append(None)
        fmap_counts += [None] * (cfg.num_layers + 2)
    for r in cfg.resolutions:
        plan = make_plan(r, T, cfg.channels, cfg.max_channels, cfg.num_layers)
        n = len(plan.layers)
        logit_counts.append(plan.valid_count(n - 1))
        fmap_counts += [plan.valid_count(i) for i in range(n)]
    return logit_counts, fmap_counts


class Discriminator(nn.Module):
    """MPD + MRD ensemble (`discriminator.py:519-578`); submodules
    ``mpd_{p}`` and ``mrd_{r}``, the JAX tree's scopes."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig()):
        super().__init__()
        self.cfg = cfg
        for p in cfg.periods:
            self.add_module(f"mpd_{p}", DiscriminatorP(
                p, channels=cfg.channels, max_channels=cfg.max_channels,
                num_layers=cfg.num_layers, compute_dtype=cfg.compute_dtype))
        for r in cfg.resolutions:
            self.add_module(f"mrd_{r}", DiscriminatorR(
                r, channels=cfg.channels, max_channels=cfg.max_channels,
                num_layers=cfg.num_layers, fixed_activation=cfg.mrd_fixed_activation,
                compute_dtype=cfg.compute_dtype, conv_impl=cfg.mrd_conv_impl))

    def forward(self, x: torch.Tensor, mrd_dtype_name: Optional[str] = None):
        """``[B, T]`` -> (list of logits, list of feature maps), the MPD's
        first; ``mrd_dtype_name`` as :meth:`DiscriminatorR.forward`'s."""
        logits: List[torch.Tensor] = []
        feats: List[torch.Tensor] = []
        for p in self.cfg.periods:
            logit, fmap = getattr(self, f"mpd_{p}")(x)
            logits.append(logit)
            feats.extend(fmap)
        for r in self.cfg.resolutions:
            logit, fmap = getattr(self, f"mrd_{r}")(x, mrd_dtype_name)
            logits.append(logit)
            feats.extend(fmap)
        return logits, feats
