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

:func:`closed_form_phase` and :func:`oscillator_bank_closed_form` hold, for
the CPU tests, the arithmetic of the closed-form design of A and I (the
phase's quadratic prefix over each half-frame in float64, each frame's
offset the sum of the earlier frames' wrapped totals as Q0.64 integers, one
sine and cosine a sample and the harmonics by the Chebyshev recurrence in
fp32). One-launch kernels on it were built and timed on the H100 but are
not in `csrc/` yet: they wait for the fp32 step checks (ROADMAP.md §3), and
`csrc/oscillator.cu` keeps its first design. The main path calls neither.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.interp import upsample_frames_to_samples
from ..dsp.synth import oscillate_harmonics
from . import build


def closed_form_phase(f0: np.ndarray, frame_size: int = 480,
                      sample_rate: int = 24000) -> np.ndarray:
    """The phase of every sample, ``[B, F*frame_size]`` float64 cycles in
    [-0.5, 0.5], by the closed-form design: the running sum of f0 / sr
    linearly interpolated (align_corners=False, edges clamped), taken mod 1.
    Inside a half-frame f0 is linear, so the sum over the half through
    sample i is ``n (cur + s ((j0 + i + 1) / (2 frame) - 0.5))`` with
    ``n = i - j0 + 1``; a frame's offset is the sum of the earlier frames'
    totals, each wrapped mod 1 and held as a Q0.64 integer (sums mod 2^64,
    exact)."""
    f = np.asarray(f0, np.float64) * (1.0 / sample_rate)
    B, F = f.shape
    idx = np.arange(F)
    prev, cur, nxt = (f[:, np.maximum(idx - 1, 0)], f, f[:, np.minimum(idx + 1, F - 1)])
    i0 = frame_size // 2
    inv2f = 0.5 / frame_size

    def prefix(i, second, base1):
        j0 = i0 if second else 0
        slope = (nxt - cur) if second else (cur - prev)
        a = (j0 + i + 1) * inv2f - 0.5
        return (i - j0 + 1) * (slope[..., None] * a + cur[..., None]) + base1

    base1 = prefix(np.array([i0 - 1]), False, 0.0)
    i = np.arange(frame_size)
    phase = np.concatenate([prefix(i[:i0], False, 0.0), prefix(i[i0:], True, base1)], -1)
    total = phase[..., -1]
    wrapped = total - np.floor(total)
    q = np.where(wrapped < 1.0, wrapped * 2.0**64, 0.0).astype(np.uint64)
    offsets = np.concatenate([np.zeros((B, 1), np.uint64), np.cumsum(q, axis=1,
                                                                     dtype=np.uint64)[:, :-1]], 1)
    x = offsets.astype(np.float64)[..., None] * 2.0**-64 + phase
    return (x - np.rint(x)).reshape(B, F * frame_size)


def _frame_interp(x: torch.Tensor, frame_size: int) -> torch.Tensor:
    """``[B, F, C]`` -> ``[B, F*frame_size, C]`` fp32: each frame's samples
    interpolated between it and its (edge-clamped) neighbours by their
    coordinate inside the frame, as kernel A does (the plain version's
    coordinates over the whole utterance round in fp32)."""
    B, F, C = x.shape
    idx = torch.arange(F)
    prev, nxt = x[:, (idx - 1).clamp(min=0)], x[:, (idx + 1).clamp(max=F - 1)]
    a = ((torch.arange(frame_size, dtype=torch.float64) + 0.5) / frame_size - 0.5)[:, None]
    y = torch.where(a < 0, prev[:, :, None] * -a + x[:, :, None] * (1 + a),
                    x[:, :, None] * (1 - a) + nxt[:, :, None] * a)
    return y.reshape(B, F * frame_size, C).float()


def oscillator_bank_closed_form(
    f0: torch.Tensor, amps: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
) -> torch.Tensor:
    """The oscillator bank by the closed-form design, ``[B, H1, L]`` fp32:
    the phase of :func:`closed_form_phase` rounded to fp32 once (as twice
    the centred phase), its sine and twice its cosine, the harmonics by
    ``sin((h+1)x) = 2 cos x sin(hx) - sin((h-1)x)`` in fp32 (one fused
    multiply-add a step), times the voiced flag and the amplitude, each
    interpolated by its coordinate inside the frame."""
    H1 = amps.shape[-1]
    turn = torch.from_numpy(2.0 * closed_form_phase(f0.numpy(), frame_size, sample_rate)).float()
    x = torch.pi * turn.double()
    sn, c2 = torch.sin(x).float(), 2.0 * torch.cos(x).float()
    uv = _frame_interp((f0 > min_frequency).double()[..., None], frame_size)[..., 0]
    amp = _frame_interp(amps.double(), frame_size)
    out, cur, prev = [], sn, torch.zeros_like(sn)
    for h in range(H1):
        out.append(cur * uv * amp[..., h])
        # a fused multiply-add: the fp32 product is exact in float64
        cur, prev = (c2.double() * cur.double() - prev.double()).float(), cur
    return torch.stack(out, 1)


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
