"""Harmonic and noise synthesis of the DSP source, in plain PyTorch.

Ports of `tinyvc_tpu/models/decoder.py::oscillate_harmonics` (the two-level
mod-1 phase scheme) and `::oscillate_noise` (random-phase spectrum times the
predicted magnitude, one zero frame prepended, inverse STFT). They are the
plain versions of kernels A and B (`kernels/oscillator.py`,
`kernels/noise.py`) and live here so that those modules and
`models/decoder.py` can share them without an import cycle.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .interp import linear_interp_last
from .phase import wrapped_exclusive_prefix
from .stft import istft


def oscillate_harmonics(
    f0: torch.Tensor,
    frame_size: int = 480,
    sample_rate: int = 24000,
    num_harmonics: int = 14,
    min_frequency: float = 20.0,
    phase0: torch.Tensor | None = None,
) -> torch.Tensor:
    """f0 ``[B, F]`` -> unit harmonics ``[B, F*frame_size, H+1]``:
    ``sin(2*pi*((k * phase) mod 1))`` masked by the interpolated voiced flag.
    ``phase0`` (cycles, ``[B]`` or a scalar tensor) seeds each row's phase:
    added to the wrapped frame offsets before the intra-frame sums, as the
    JAX function adds it (chunked conversion's per-chunk seed)."""
    B, nf = f0.shape
    Lw = nf * frame_size
    f0w = linear_interp_last(f0.float(), Lw)
    d = (f0w / sample_rate).reshape(B, nf, frame_size)
    intra = torch.cumsum(d, dim=-1)
    frame_sums = intra[..., -1]
    offsets = wrapped_exclusive_prefix(frame_sums - torch.floor(frame_sums))[..., None]
    if phase0 is not None:
        offsets = phase0.float().reshape(-1, 1, 1) + offsets
    phase = (offsets + intra).reshape(B, Lw)
    k = torch.arange(1, num_harmonics + 2, dtype=torch.float32, device=f0.device)
    theta = 2.0 * math.pi * torch.remainder(phase[..., None] * k, 1.0)
    uv = linear_interp_last((f0 > min_frequency).float(), Lw)
    return torch.sin(theta) * uv[..., None]


def oscillate_noise(
    kernel: torch.Tensor, angle: torch.Tensor, frame_size: int = 480, n_fft: int = 1920
) -> torch.Tensor:
    """Filtered noise: magnitude ``[B, F, bins]`` with phases ``angle`` (same
    shape) -> ``[B, F*frame_size]``."""
    spec = torch.polar(kernel.float(), angle.float())
    spec = F.pad(spec, (0, 0, 1, 0))
    return istft(spec, n_fft, frame_size)
