"""Kernel B: filtered noise from hashed phases (`csrc/noise.cu`).

Replaces `tinyvc_tpu/ops/pallas/noise.py::pallas_oscillate_noise`: magnitude
``[B, F, bins]`` -> noise ``[B, F*hop]`` by a unit-phase spectrum, one
prepended zero frame and the inverse STFT. The phases come from the TPU
kernel's murmur3 counter hash, so the same int32 seed gives the same noise
bit for bit (:func:`noise_angles`); an explicit ``angle`` replaces them.
The port holds itself to the JAX kernel's ``dtype_name="float32"`` result:
the bf16 default there is a TPU matrix-unit choice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..dsp.stft import hann_window
from ..dsp.synth import oscillate_noise
from . import build

_M32 = 0xFFFFFFFF
_TWO_PI = float(np.float32(2.0 * np.pi))
_PI = float(np.float32(np.pi))


def rows_total(num_frames: int) -> int:
    """Padded spectrum rows of the TPU kernel (`noise.py:196-208`), which
    the hash index depends on: tile ``t`` is the largest multiple of 8 in
    128..8 dividing F (else 128), ``rows = t + 3`` rounded up to 8."""
    t = 128
    for cand in range(128, 7, -8):
        if num_frames % cand == 0:
            t = cand
            break
    nt = -(-num_frames // t)
    rows = t + 3
    rows += (-rows) % 8
    return max(2 + num_frames, (nt - 1) * t + rows)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` < 2**32 without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _murmur_mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def noise_angles(batch: int, num_frames: int, bins: int, seed: int, device=None) -> torch.Tensor:
    """The hashed phases ``[B, F, bins]`` in [-pi, pi) for ``seed``, equal
    bit for bit to those the TPU kernel synthesises for the same shape."""
    b = torch.arange(batch, dtype=torch.int64, device=device)[:, None, None]
    p = torch.arange(num_frames, dtype=torch.int64, device=device)[None, :, None] + 2
    k = torch.arange(bins, dtype=torch.int64, device=device)[None, None, :]
    idx = ((b * rows_total(num_frames) + p) * 1024 + k) & _M32
    h = _murmur_mix(idx ^ (int(seed) & _M32))
    u = (h >> 9).to(torch.float32) * (2.0 ** -23)
    return u * _TWO_PI - _PI


def oscillate_noise_plain(
    mag: torch.Tensor, seed: int, frame_size: int = 480, n_fft: int = 1920,
    angle: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: hashed (or given) phases, then `istft`."""
    if angle is None:
        B, F, bins = mag.shape
        angle = noise_angles(B, F, bins, seed, mag.device)
    return oscillate_noise(mag, angle, frame_size, n_fft)


@functools.lru_cache(maxsize=None)
def _dft_tables(n_fft: int, device: torch.device):
    """cos/sin of 2*pi*m/n_fft (computed in float64) and the hann window."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(device)
    return cos, sin, hann_window(n_fft, device).contiguous()


def oscillate_noise_hashed(
    mag: torch.Tensor, seed: int, frame_size: int = 480, n_fft: int = 1920,
    angle: torch.Tensor | None = None,
) -> torch.Tensor:
    """mag ``[B, F, n_fft//2+1]`` -> noise ``[B, F*frame_size]``. CPU tensors
    take the plain version; CUDA tensors launch kernel B."""
    if n_fft != 4 * frame_size:
        raise ValueError("the noise synthesis needs n_fft == 4 * frame_size")
    tensors = (mag,) if angle is None else (mag, angle)
    if build.on_cpu(*tensors):
        return oscillate_noise_plain(mag, seed, frame_size, n_fft, angle)
    build.check_input("mag", mag, 3)
    B, F, bins = mag.shape
    if bins != n_fft // 2 + 1:
        raise ValueError(f"mag has {bins} bins, expected {n_fft // 2 + 1}")
    if angle is not None:
        build.check_input("angle", angle, 3)
        if angle.shape != mag.shape:
            raise ValueError(f"angle {tuple(angle.shape)} != mag {tuple(mag.shape)}")
    cos, sin, win = _dft_tables(n_fft, mag.device)
    out = torch.empty((B, F * frame_size), device=mag.device, dtype=torch.float32)
    build.launch("tvc_noise", mag, mag, angle, cos, sin, win, out,
                 B, F, bins, n_fft, frame_size, rows_total(F), int(np.int64(seed).astype(np.int32)))
    oscillate_noise_hashed.launches += 1
    return out


oscillate_noise_hashed.launches = 0
