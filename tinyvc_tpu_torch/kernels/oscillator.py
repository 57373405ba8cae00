"""Kernels A and I: the additive oscillator bank and its amplitude
gradient (`csrc/oscillator.cu`).

- A replaces `tinyvc_tpu/ops/pallas/oscillator.py::_pallas_forward`, the
  forward of ``oscillator_bank``: f0 ``[B, F]`` and amplitudes
  ``[B, F, H1]`` at frame rate -> modulated harmonics ``[B, H1, F*frame]``
  (channels-first, the layout `models/decoder.py::Decoder.dsp`
  concatenates).
- I replaces ``_pallas_backward_amps``: the cotangent ``[B, H1, F*frame]``
  -> the amplitudes' gradient ``[B, F, H1]``, with the phase recomputed as
  A computes it.

:class:`OscillatorBank` is the differentiable bank of the training step,
forward A and backward I; f0 gets no gradient, as with the JAX package's
``grad_f0=False`` (f0 comes from the frozen encoder). Bound and design are
in the CUDA source's header.
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


def oscillator_amps_grad_plain(
    f0: torch.Tensor, g: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
) -> torch.Tensor:
    """Plain PyTorch version: the vjp of ``oscillator_bank_plain`` with
    respect to the amplitudes, by autograd through its frame interpolation."""
    B, H1, L = g.shape
    harm = oscillate_harmonics(f0, frame_size, sample_rate, H1 - 1, min_frequency)
    amps = torch.zeros((B, L // frame_size, H1), device=g.device, requires_grad=True)
    with torch.enable_grad():
        y = upsample_frames_to_samples(amps, frame_size)
        (damps,) = torch.autograd.grad(y, amps, g.float().transpose(1, 2) * harm)
    return damps


def oscillator_amps_grad(
    f0: torch.Tensor, g: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
) -> torch.Tensor:
    """f0 ``[B, F]``, cotangent ``[B, H1, F*frame_size]`` -> the gradient of
    the amplitudes ``[B, F, H1]``. CPU tensors take the plain version; CUDA
    tensors launch kernel I."""
    if build.on_cpu(f0, g):
        return oscillator_amps_grad_plain(f0, g, frame_size, sample_rate, min_frequency)
    build.check_input("f0", f0, 2)
    build.check_input("g", g, 3)
    B, F = f0.shape
    H1 = g.shape[1]
    if g.shape != (B, H1, F * frame_size):
        raise ValueError(f"g {tuple(g.shape)} does not match f0 {tuple(f0.shape)}")
    frame_sums = torch.empty((B, F), device=f0.device, dtype=torch.float32)
    parts = torch.empty((B, F, 3, H1), device=f0.device, dtype=torch.float32)
    damps = torch.empty((B, F, H1), device=f0.device, dtype=torch.float32)
    build.launch("tvc_oscillator_amps_grad", f0, f0, g, frame_sums, parts, damps,
                 B, F, H1, frame_size, float(sample_rate), float(min_frequency))
    oscillator_amps_grad.launches += 1
    return damps


oscillator_amps_grad.launches = 0


class OscillatorBank(torch.autograd.Function):
    """The differentiable oscillator bank: forward :func:`oscillator_bank`
    (kernel A), backward :func:`oscillator_amps_grad` (kernel I); no
    gradient for f0."""

    @staticmethod
    def forward(ctx, f0, amps, frame_size, sample_rate, min_frequency):
        f0 = f0.detach().float().contiguous()
        ctx.save_for_backward(f0)
        ctx.args = (frame_size, sample_rate, min_frequency)
        return oscillator_bank(f0, amps.detach().float().contiguous(), frame_size, sample_rate,
                               min_frequency)

    @staticmethod
    def backward(ctx, g):
        (f0,) = ctx.saved_tensors
        damps = oscillator_amps_grad(f0, g.float().contiguous(), *ctx.args)
        return None, damps, None, None, None
