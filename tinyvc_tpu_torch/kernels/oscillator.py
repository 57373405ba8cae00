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

:func:`closed_form_phase`, :func:`oscillator_bank_closed_form` and
:func:`oscillator_amps_grad_closed_form` mirror the kernels' arithmetic for
the CPU tests (the main path does not call them): the phase's quadratic
prefix over each half-frame in float64, each frame's offset the sum of the
earlier frames' wrapped totals as Q0.64 integers, the harmonics from one
sine and cosine a sample by the Chebyshev recurrence in fp32, and I's sums
in the kernel's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.interp import upsample_frames_to_samples
from ..dsp.synth import oscillate_harmonics
from . import build


# Harmonics kernel I takes (`csrc/oscillator.cu::kMaxH1`: four rounds of 8).
MAX_GRAD_HARMONICS = 32
_LANES = 32


def _wrap_q(t: np.ndarray) -> np.ndarray:
    """Cycles wrapped mod 1 as Q0.64 integers (`csrc/oscillator.cu::wrap_q`)."""
    wrapped = t - np.floor(t)
    return np.where(wrapped < 1.0, wrapped * 2.0**64, 0.0).astype(np.uint64)


def closed_form_phase(f0: np.ndarray, frame_size: int = 480,
                      sample_rate: int = 24000, phase0: np.ndarray | None = None) -> np.ndarray:
    """The phase of every sample, ``[B, F*frame_size]`` float64 cycles in
    [-0.5, 0.5], as kernels A and I compute it (`csrc/oscillator.cu::
    FramePhase`, `frame_q`, `base_harmonic`): the running sum of f0 / sr
    linearly interpolated (align_corners=False, edges clamped), taken mod 1.
    Inside a half-frame f0 is linear, so the sum over the half through
    sample i is ``n (cur + s ((j0 + i + 1) / (2 frame) - 0.5))`` with
    ``n = i - j0 + 1``; a frame's offset is the sum of the earlier frames'
    totals, each wrapped mod 1 and held as a Q0.64 integer (sums mod 2^64,
    exact), plus the row's seed ``phase0`` ``[B]`` (fp32 cycles) wrapped
    the same way, as kernel A adds it."""
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
    q = _wrap_q(phase[..., -1])
    offsets = np.concatenate([np.zeros((B, 1), np.uint64), np.cumsum(q, axis=1,
                                                                     dtype=np.uint64)[:, :-1]], 1)
    if phase0 is not None:
        seed = _wrap_q(np.asarray(phase0, np.float32).astype(np.float64).reshape(B, 1))
        with np.errstate(over="ignore"):
            offsets = offsets + seed  # mod 2^64, as the kernel's integer add
    x = offsets.astype(np.float64)[..., None] * 2.0**-64 + phase
    return (x - np.rint(x)).reshape(B, F * frame_size)


def _frame_interp(x: torch.Tensor, frame_size: int) -> torch.Tensor:
    """``[B, F, C]`` -> ``[B, F*frame_size, C]`` fp32: each frame's samples
    interpolated between it and its (edge-clamped) neighbours by their
    coordinate inside the frame, as the kernels do (the plain version's
    coordinates over the whole utterance round in fp32)."""
    B, F, C = x.shape
    idx = torch.arange(F)
    prev, nxt = x[:, (idx - 1).clamp(min=0)], x[:, (idx + 1).clamp(max=F - 1)]
    a = ((torch.arange(frame_size, dtype=torch.float64) + 0.5) / frame_size - 0.5)[:, None]
    y = torch.where(a < 0, prev[:, :, None] * -a + x[:, :, None] * (1 + a),
                    x[:, :, None] * (1 - a) + nxt[:, :, None] * a)
    return y.reshape(B, F * frame_size, C).float()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``fmaf(a, b, c)``: the product of two fp32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _base_harmonic(f0: torch.Tensor, frame_size: int, sample_rate: int, phase0=None):
    """Each sample's sine and twice its cosine, fp32, as the kernels'
    `base_harmonic` takes them: the phase of :func:`closed_form_phase`
    rounded to fp32 once (as twice the centred phase)."""
    seed = None if phase0 is None else phase0.numpy()
    turn = torch.from_numpy(2.0 * closed_form_phase(f0.numpy(), frame_size, sample_rate,
                                                    seed)).float()
    x = torch.pi * turn.double()
    return torch.sin(x).float(), 2.0 * torch.cos(x).float()


def oscillator_bank_closed_form(
    f0: torch.Tensor, amps: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
    phase0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel A's output by its own arithmetic, ``[B, H1, L]`` fp32: the
    phase of :func:`closed_form_phase` (seeded by ``phase0``) rounded to
    fp32 once (as twice the centred phase), its sine and twice its cosine,
    the harmonics by ``sin((h+1)x) = 2 cos x sin(hx) - sin((h-1)x)`` in
    fp32, times the interpolated voiced flag and amplitude."""
    H1 = amps.shape[-1]
    sn, c2 = _base_harmonic(f0, frame_size, sample_rate, phase0)
    uv = _frame_interp((f0 > min_frequency).double()[..., None], frame_size)[..., 0]
    amp = _frame_interp(amps.double(), frame_size)
    out, cur, prev = [], sn, torch.zeros_like(sn)
    for h in range(H1):
        out.append(cur * uv * amp[..., h])
        cur, prev = _fma(c2, cur, -prev), cur
    return torch.stack(out, 1)


def _lane_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``[..., 32]`` lane values -> ``[...]``, summed as kernel I's warp
    does: pairs across lane bit 8, then 4, 2, 1 (its reduce-scatter), then 16."""
    x = x.reshape(*x.shape[:-1], 2, 2, 2, 2, 2)  # lane bits 16, 8, 4, 2, 1
    for dim in (-4, -3, -2, -1, -1):  # bit 8 first; each sum drops its dim
        x = x.select(dim, 0) + x.select(dim, 1)
    return x


def oscillator_amps_grad_closed_form(
    f0: torch.Tensor, g: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
) -> torch.Tensor:
    """Kernel I's output by its own arithmetic and order, ``[B, F, H1]``
    fp32: the harmonics of :func:`oscillator_bank_closed_form`; a lane's
    sums over its samples (4 a lane when the frame is a multiple of 8, else
    1) by fused multiply-adds; the lanes of a warp summed as its
    reduce-scatter sums them, the half-frame's warps in order; then the
    frame's sums for the previous, current and next frame's weight,
    shift-added as its second launch does."""
    B, F = f0.shape
    H1 = g.shape[1]
    vec = 4 if frame_size % 8 == 0 else 1
    sc, c2 = _base_harmonic(f0, frame_size, sample_rate)
    sp = torch.zeros_like(sc)
    uv = _frame_interp((f0 > min_frequency).double()[..., None], frame_size)[..., 0]
    a = ((torch.arange(frame_size, dtype=torch.float32) + 0.5) / frame_size - 0.5).repeat(F)
    i0 = frame_size // 2
    first = (torch.arange(frame_size) < i0).repeat(F)
    w1 = uv * torch.where(first, -a, 1.0 - a)  # the previous frame's weight, then the current
    w2 = uv * torch.where(first, 1.0 + a, a)  # the current frame's, then the next
    units = -(-(frame_size - i0) // vec)  # the larger half's: a lane each
    warps = -(-units // _LANES)  # warps a half-frame

    def half_sums(m, w, lo, hi):
        """[B, F] sum of m * w over the half's samples [lo, hi), the kernel's order."""
        pad = warps * _LANES * vec - (hi - lo)
        prod_m = torch.nn.functional.pad(m.view(B, F, frame_size)[..., lo:hi], (0, pad))
        prod_w = torch.nn.functional.pad(w.view(B, F, frame_size)[..., lo:hi], (0, pad))
        prod_m = prod_m.view(B, F, warps * _LANES, vec)
        prod_w = prod_w.view(B, F, warps * _LANES, vec)
        acc = prod_m.new_zeros(B, F, warps * _LANES)
        for v in range(vec):
            acc = _fma(prod_m[..., v], prod_w[..., v], acc)
        lanes = _lane_tree_sum(acc.view(B, F, warps, _LANES))
        total = lanes[..., 0]
        for k in range(1, warps):
            total = total + lanes[..., k]
        return total

    parts = torch.empty(B, F, 3, H1)
    for h in range(H1):
        m = g[:, h].float() * sc
        parts[:, :, 0, h] = half_sums(m, w1, 0, i0)
        parts[:, :, 1, h] = half_sums(m, w2, 0, i0) + half_sums(m, w1, i0, frame_size)
        parts[:, :, 2, h] = half_sums(m, w2, i0, frame_size)
        sc, sp = _fma(c2, sc, -sp), sc
    damps = parts[:, :, 1].clone()
    damps[:, :-1] += parts[:, 1:, 0]
    damps[:, 0] += parts[:, 0, 0]
    damps[:, 1:] += parts[:, :-1, 2]
    damps[:, -1] += parts[:, -1, 2]
    return damps


def oscillator_bank_plain(
    f0: torch.Tensor, amps: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
    phase0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``oscillate_harmonics(f0, phase0=phase0) *
    interp(amps)``, transposed to ``[B, H1, L]``."""
    H1 = amps.shape[-1]
    harm = oscillate_harmonics(f0, frame_size, sample_rate, H1 - 1, min_frequency, phase0)
    out = harm * upsample_frames_to_samples(amps.float(), frame_size)
    return out.transpose(1, 2).contiguous()


def oscillator_bank(
    f0: torch.Tensor, amps: torch.Tensor, frame_size: int = 480,
    sample_rate: int = 24000, min_frequency: float = 20.0,
    phase0: torch.Tensor | None = None,
) -> torch.Tensor:
    """f0 ``[B, F]``, amps ``[B, F, H1]`` -> ``[B, H1, F*frame_size]``;
    ``phase0`` ``[B]`` (fp32 cycles) seeds each row's phase, none starts
    every row at 0. CPU tensors take the plain version; CUDA tensors launch
    kernel A."""
    tensors = (f0, amps) if phase0 is None else (f0, amps, phase0)
    if build.on_cpu(*tensors):
        return oscillator_bank_plain(f0, amps, frame_size, sample_rate, min_frequency, phase0)
    build.check_input("f0", f0, 2)
    build.check_input("amps", amps, 3)
    B, F = f0.shape
    H1 = amps.shape[-1]
    if amps.shape[:2] != (B, F):
        raise ValueError(f"amps {tuple(amps.shape)} does not match f0 {tuple(f0.shape)}")
    if phase0 is not None:
        build.check_input("phase0", phase0, 1)
        if phase0.shape != (B,):
            raise ValueError(f"phase0 {tuple(phase0.shape)} does not match f0 {tuple(f0.shape)}")
    out = torch.empty((B, H1, F * frame_size), device=f0.device, dtype=torch.float32)
    build.launch("tvc_oscillator", f0, f0, amps, phase0, out,
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
    tensors launch kernel I, which reads ``g`` in 16-byte loads: a ``g``
    that does not start on a 16-byte boundary raises."""
    if build.on_cpu(f0, g):
        return oscillator_amps_grad_plain(f0, g, frame_size, sample_rate, min_frequency)
    build.check_input("f0", f0, 2)
    build.check_input("g", g, 3)
    B, F = f0.shape
    H1 = g.shape[1]
    if g.shape != (B, H1, F * frame_size):
        raise ValueError(f"g {tuple(g.shape)} does not match f0 {tuple(f0.shape)}")
    if H1 > MAX_GRAD_HARMONICS:
        raise ValueError(f"g has {H1} harmonics; kernel I takes at most {MAX_GRAD_HARMONICS}")
    if g.data_ptr() % 16:
        raise ValueError("g: kernel I needs a tensor that starts on a 16-byte boundary")
    parts = torch.empty((B, F, 3, H1), device=f0.device, dtype=torch.float32)
    damps = torch.empty((B, F, H1), device=f0.device, dtype=torch.float32)
    build.launch("tvc_oscillator_amps_grad", f0, f0, g, parts, damps,
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
        g = g.float().contiguous()
        if g.data_ptr() % 16:  # a view into a larger gradient: kernel I's 16-byte loads
            g = g.clone()
        damps = oscillator_amps_grad(f0, g, *ctx.args)
        return None, damps, None, None, None
