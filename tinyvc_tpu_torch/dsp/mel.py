"""Log-mel spectrogram and the log-mel L1 distance (counterpart of
`tinyvc_tpu/dsp/mel.py` and `tinyvc_tpu/train/losses.py::log_mel_loss`).

torchaudio's ``MelSpectrogram`` defaults at sr 24000, n_fft 1024, hop 256,
80 mels: power 2, HTK mel scale, no filterbank norm, frame 0 kept.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .stft import stft_magnitude


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int = 24000, n_fft: int = 1024, n_mels: int = 80,
                   f_min: float = 0.0, f_max: float | None = None) -> np.ndarray:
    """Triangular HTK filterbank ``[n_fft//2+1, n_mels]`` from ``f_min`` to
    ``f_max`` (default: Nyquist)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate // 2, n_bins)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel_spectrogram(
    wave: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1024,
    hop: int = 256, n_mels: int = 80, eps: float = 1e-6,
) -> torch.Tensor:
    """wave ``[B, L]`` -> ``log(power mel + eps)`` ``[B, L//hop + 1, n_mels]``."""
    return torch.log(mel_spectrogram(wave, sample_rate, n_fft, hop, n_mels) + eps)


def mel_spectrogram(
    wave: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1024,
    hop: int = 256, n_mels: int = 80,
) -> torch.Tensor:
    """wave ``[B, L]`` -> power mel ``[B, L//hop + 1, n_mels]`` of the
    gradient-safe magnitude."""
    mag = stft_magnitude(wave, n_fft, hop, grad_safe=True)
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(wave.device)
    return (mag * mag) @ fb


def log_mel_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean absolute log-mel difference of two ``[L]`` waveforms, cut to the
    shorter length (the metric of `demo/two_speaker/metrics.json`)."""
    n = min(a.shape[-1], b.shape[-1])
    ma = log_mel_spectrogram(a[None, :n].float())
    mb = log_mel_spectrogram(b[None, :n].float())
    return float(torch.mean(torch.abs(torch.nan_to_num(ma) - torch.nan_to_num(mb))))
