"""Kernel A: the additive oscillator bank (`csrc/oscillator.cu`).

Replaces `tinyvc_tpu/ops/pallas/oscillator.py::_pallas_forward`, the forward
of ``oscillator_bank``: f0 ``[B, F]`` and amplitudes ``[B, F, H1]`` at frame
rate -> modulated harmonics ``[B, H1, F*frame]`` (channels-first, the layout
`models/decoder.py::Decoder.dsp` concatenates). Bound and design are in the
CUDA source's header.
"""

from __future__ import annotations

import torch

from ..dsp.interp import upsample_frames_to_samples
from ..dsp.synth import oscillate_harmonics
from . import build


def oscillator_bank_plain(
    f0: torch.Tensor, amps: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
) -> torch.Tensor:
    """Plain PyTorch version: ``oscillate_harmonics(f0) * interp(amps)``,
    transposed to ``[B, H1, L]``."""
    H1 = amps.shape[-1]
    harm = oscillate_harmonics(f0, frame_size, sample_rate, H1 - 1, min_frequency)
    out = harm * upsample_frames_to_samples(amps.float(), frame_size)
    return out.transpose(1, 2).contiguous()


def oscillator_bank(
    f0: torch.Tensor, amps: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
) -> torch.Tensor:
    """f0 ``[B, F]``, amps ``[B, F, H1]`` -> ``[B, H1, F*frame_size]``.
    CPU tensors take the plain version; CUDA tensors launch kernel A."""
    if build.on_cpu(f0, amps):
        return oscillator_bank_plain(f0, amps, frame_size, sample_rate, min_frequency)
    build.check_input("f0", f0, 2)
    build.check_input("amps", amps, 3)
    B, F = f0.shape
    H1 = amps.shape[-1]
    if amps.shape[:2] != (B, F):
        raise ValueError(f"amps {tuple(amps.shape)} does not match f0 {tuple(f0.shape)}")
    out = torch.empty((B, H1, F * frame_size), device=f0.device, dtype=torch.float32)
    frame_sums = torch.empty((B, F), device=f0.device, dtype=torch.float32)
    build.launch("tvc_oscillator", f0, f0, amps, frame_sums, out,
                 B, F, H1, frame_size, float(sample_rate), float(min_frequency))
    oscillator_bank.launches += 1
    return out


oscillator_bank.launches = 0
