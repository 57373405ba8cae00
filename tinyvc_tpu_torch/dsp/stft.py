"""STFT magnitude and inverse STFT (counterpart of `tinyvc_tpu/dsp/stft.py`).

Every transform here has ``n_fft == 4 * hop``. Framing is reflect padding
plus ``unfold``, and the inverse overlap-adds four shifted hop blocks, as the
JAX package does. The fp32 real FFT is ``torch.fft``, and the training loss's
``impl="matmul"`` magnitude a ``torch.matmul``: the JAX package computes both
outside any Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _hann_np(n_fft: int) -> np.ndarray:
    n = np.arange(n_fft)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)


def hann_window(n_fft: int, device=None) -> torch.Tensor:
    """Periodic hann window, identical to ``torch.hann_window(n_fft)``, on
    ``device``. Read only: the tensor is shared between calls."""
    return _hann(n_fft, torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=None)
def _hann(n_fft: int, device: torch.device) -> torch.Tensor:
    """The window copied to ``device`` once, not with every call (a copy
    from pageable host memory waits for the device). Made outside inference
    mode, so that autograd may save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_hann_np(n_fft)).to(device)


def _frame(x: torch.Tensor, n_fft: int, hop: int, drop_first: bool) -> torch.Tensor:
    """``[B, L]`` -> ``[B, F, n_fft]`` frames with centre reflect padding;
    ``drop_first`` removes frame 0 (the reference's ``spec[:, :, 1:]``)."""
    if n_fft % hop:
        raise ValueError("n_fft must be a multiple of hop")
    L = x.shape[-1]
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)[:, : 1 + L // hop]
    return frames[:, 1:] if drop_first else frames


def stft(x: torch.Tensor, n_fft: int, hop: int, drop_first: bool = False) -> torch.Tensor:
    """Complex STFT of ``[B, L]`` -> ``[B, F, n_fft//2+1]`` (fp32)."""
    frames = _frame(x.float(), n_fft, hop, drop_first)
    return torch.fft.rfft(frames * hann_window(n_fft, x.device), dim=-1)


MAG_EPS = 1e-24  # inside the sqrt: shifts magnitudes by <= 1e-12 absolute


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int, drop_first: bool = False,
                   grad_safe: bool = False) -> torch.Tensor:
    """``|stft(x)|``; with ``grad_safe``, ``sqrt(re^2 + im^2 + 1e-24)``
    (`tinyvc_tpu/dsp/stft.py::_safe_magnitude`), whose gradient stays
    finite at silence where the bare magnitude's is re/0. The training
    losses take the safe form; the serving spectrogram keeps the bare one."""
    y = stft(x, n_fft, hop, drop_first=drop_first)
    if grad_safe:
        return torch.sqrt(y.real * y.real + y.imag * y.imag + MAG_EPS)
    return y.abs()


@functools.lru_cache(maxsize=None)
def _windowed_dft_np(n_fft: int) -> np.ndarray:
    """``[n_fft, 2*bins]`` (cos | -sin) real-DFT matrix with the hann
    window folded in: ``|rfft(w * f)| == mag(f @ D)``
    (`tinyvc_tpu/dsp/stft.py::_windowed_dft`)."""
    bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    d = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return (_hann_np(n_fft)[:, None].astype(np.float64) * d).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _windowed_dft(n_fft: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The matrix rounded to ``dtype`` and held as fp32 on ``device``, made
    once (outside inference mode, so that autograd may save it)."""
    with torch.inference_mode(False):
        d = torch.from_numpy(_windowed_dft_np(n_fft)).to(device)
        return d.to(dtype).float()


def stft_magnitude_matmul(x: torch.Tensor, n_fft: int, hop: int, drop_first: bool = False,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The gradient-safe magnitude STFT as frames @ windowed-DFT matrix
    (`tinyvc_tpu/dsp/stft.py::stft_magnitude_matmul`). JAX multiplies
    ``dtype`` operands with fp32 sums (``preferred_element_type``), so
    nothing is rounded after the product: here the frames and the matrix
    are rounded to ``dtype`` and multiplied as fp32 with TF32 off (a
    product of two bf16 values is exact in fp32)."""
    from ..infer.generator import exact_fp32

    frames = _frame(x.float(), n_fft, hop, drop_first).to(dtype).float()
    with exact_fp32():
        y = torch.matmul(frames, _windowed_dft(n_fft, torch.device(x.device), dtype))
    bins = n_fft // 2 + 1
    re, im = y[..., :bins], y[..., bins:]
    return torch.sqrt(re * re + im * im + MAG_EPS)


def spectrogram(x: torch.Tensor, n_fft: int = 1920, hop: int = 480) -> torch.Tensor:
    """Magnitude spectrogram ``[B, L//hop, n_fft//2+1]`` with frame 0
    dropped; L must be a multiple of ``hop``."""
    return stft(x, n_fft, hop, drop_first=True).abs()


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Inverse STFT matching ``torch.istft(..., center=True)``: complex
    ``[B, F, n_fft//2+1]`` -> ``[B, (F-1)*hop]`` fp32. Hann synthesis window,
    overlap-add, window-envelope normalisation, centre trim."""
    return overlap_add(torch.fft.irfft(spec, n=n_fft, dim=-1), hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """The rest of :func:`istft` after the inverse FFT: real frames
    ``[B, F, n_fft]`` times the hann window, overlap-added, divided by the
    window envelope, centre-trimmed to ``[B, (F-1)*hop]``."""
    B, nf, n_fft = frames.shape
    ratio = n_fft // hop
    win = hann_window(n_fft, frames.device)
    frames = (frames * win).reshape(B, nf, ratio, hop)
    nb = nf + ratio - 1
    out = frames.new_zeros(B, nb, hop)
    env = frames.new_zeros(1, nb, hop)
    w2 = (win * win).reshape(ratio, hop)
    for r in range(ratio):
        out[:, r : r + nf] += frames[:, :, r]
        env[:, r : r + nf] += w2[r]
    pad = n_fft // 2
    length = (nf - 1) * hop
    y = out.reshape(B, nb * hop)[:, pad : pad + length]
    env = env.reshape(1, nb * hop)[:, pad : pad + length]
    return y / env.clamp_min(1e-11)
