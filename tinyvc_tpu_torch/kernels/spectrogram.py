"""Kernel G: the magnitude spectrogram by an FFT inside the kernel
(`csrc/spectrogram.cu`, `csrc/fft.cuh`).

Replaces `tinyvc_tpu/ops/pallas/spectrogram.py::pallas_spectrogram`: wave
``[B, L]`` -> ``[B, L/hop, n_fft/2+1]`` fp32, the centre reflect padding and
frame-0 drop of `dsp/stft.py::spectrogram`: the frames times the fp32 hann
window, transformed, ``sqrt(re^2 + im^2)``. The kernel runs a mixed-radix
FFT whose twiddles are entries of a float64 table rounded to fp32
(:func:`_table_np`; `kernels/fft.py` mirrors its decomposition); the plain
version multiplies with the DFT matrix built from the same table (the TPU
builds the matrix itself in float64, `_dft_splits`). The serving profile
runs it where `infer/generator.py::serving_spectrogram` picks it. Both stay
within ~1e-6 of the peak of the exact transform; the TPU's default bf16x3
split is ~1.5e-5 relative.

CPU tensors take the plain version; CUDA tensors launch kernel G, which
takes an even ``n_fft <= 2048`` whose half has the prime factors 2, 3 and
5 only; any other raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..dsp.stft import _frame, hann_window
from . import build
from .fft import check_n_fft


@functools.lru_cache(maxsize=None)
def _table_np(n_fft: int) -> np.ndarray:
    """``[2, n_fft]``: cos and -sin of ``2*pi*m/n_fft`` (float64, then fp32):
    the kernel's twiddles and the plain version's DFT matrix entries."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(n_fft: int, device: torch.device):
    """The kernel's cos/-sin table and the hann window, on ``device``."""
    return torch.from_numpy(_table_np(n_fft)).to(device), hann_window(n_fft, device)


@functools.lru_cache(maxsize=4)
def dft_matrix(n_fft: int, device: torch.device) -> torch.Tensor:
    """The packed ``[n_fft, 2*bins]`` (cos | -sin) DFT matrix, entry
    ``(n, k)`` from :func:`_table_np` at ``(n*k) mod n_fft``."""
    bins = n_fft // 2 + 1
    idx = (np.arange(n_fft)[:, None] * np.arange(bins)[None, :]) % n_fft
    t = _table_np(n_fft)
    return torch.from_numpy(np.concatenate([t[0][idx], t[1][idx]], axis=1)).to(device)


def spectrogram_plain(x: torch.Tensor, n_fft: int = 1920, hop: int = 480) -> torch.Tensor:
    """Plain PyTorch version: framed, windowed, one fp32 matmul with
    :func:`dft_matrix`, then the magnitude."""
    bins = n_fft // 2 + 1
    frames = _frame(x.float(), n_fft, hop, drop_first=True) * hann_window(n_fft, x.device)
    y = torch.matmul(frames, dft_matrix(n_fft, x.device))
    re, im = y[..., :bins], y[..., bins:]
    return torch.sqrt(re * re + im * im)


def spectrogram(x: torch.Tensor, n_fft: int = 1920, hop: int = 480) -> torch.Tensor:
    """Magnitude spectrogram ``[B, L]`` -> ``[B, L//hop, n_fft//2+1]`` fp32,
    frame 0 dropped; ``L`` a multiple of ``hop``. CPU tensors take the plain
    version; CUDA tensors launch kernel G."""
    if build.on_cpu(x):
        return spectrogram_plain(x, n_fft, hop)
    build.check_input("x", x, 2)
    B, L = x.shape
    if L % hop or n_fft % hop or L <= n_fft // 2:
        raise ValueError(f"need L ({L}) a multiple of hop ({hop}) and > n_fft/2 ({n_fft // 2})")
    check_n_fft(n_fft)
    out = torch.empty((B, L // hop, n_fft // 2 + 1), device=x.device, dtype=torch.float32)
    table, win = _tables(n_fft, x.device)
    build.launch("tvc_spectrogram", x, x, table, win, out, B, L, n_fft, hop)
    spectrogram.launches += 1
    return out


spectrogram.launches = 0
