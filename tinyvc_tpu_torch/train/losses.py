"""Training losses (counterpart of `tinyvc_tpu/train/losses.py`): the
multi-scale STFT loss and the log-mel L1 loss.

The multi-scale STFT loss takes the fp32 rfft magnitude, the JAX package's
``impl="rfft"`` (its choice off the TPU). Its ``impl="matmul"`` form, a
bf16 windowed-DFT product, is a lowering choice of the TPU's matrix unit
and is not ported (`ROADMAP.md` §1).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..dsp.mel import mel_spectrogram
from ..dsp.stft import stft_magnitude


def _safe_log(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(x + eps)


def multi_scale_stft_loss(
    x: torch.Tensor, y: torch.Tensor, scales: Sequence[int] = (16, 32, 64, 128, 256, 512),
) -> torch.Tensor:
    """L2 on magnitude + L1 on log magnitude, averaged over scales (hop s,
    n_fft 4s, frame 0 kept, the gradient-safe magnitude)."""
    x, y = x.float(), y.float()
    loss = 0.0
    for s in scales:
        xs = torch.nan_to_num(stft_magnitude(x, s * 4, s, grad_safe=True))
        ys = torch.nan_to_num(stft_magnitude(y, s * 4, s, grad_safe=True))
        loss = loss + torch.mean((xs - ys) ** 2) + torch.mean(
            torch.abs(_safe_log(xs) - _safe_log(ys)))
    return loss / len(scales)


def log_mel_loss(
    x: torch.Tensor, y: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1024,
    hop: int = 256, n_mels: int = 80,
) -> torch.Tensor:
    """L1 between log power-mel spectrograms."""
    xm = _safe_log(mel_spectrogram(x.float(), sample_rate, n_fft, hop, n_mels))
    ym = _safe_log(mel_spectrogram(y.float(), sample_rate, n_fft, hop, n_mels))
    return torch.mean(torch.abs(torch.nan_to_num(xm) - torch.nan_to_num(ym)))
