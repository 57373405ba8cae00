"""Training losses (counterpart of `tinyvc_tpu/train/losses.py`): the
multi-scale STFT loss, the log-mel L1 loss, and the GAN's LSGAN and
feature-matching losses.

The multi-scale STFT loss takes the fp32 rfft magnitude by default
(``impl="auto"``), the JAX package's choice off the TPU, on the CPU and on
CUDA alike; ``impl="matmul"``, the bf16 windowed-DFT product that JAX
takes on the TPU (`dsp/stft.py::stft_magnitude_matmul`), only when asked
for.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from ..dsp.mel import mel_spectrogram
from ..dsp.stft import stft_magnitude, stft_magnitude_matmul


def _safe_log(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(x + eps)


def multi_scale_stft_loss(
    x: torch.Tensor, y: torch.Tensor, scales: Sequence[int] = (16, 32, 64, 128, 256, 512),
    impl: str = "auto",
) -> torch.Tensor:
    """L2 on magnitude + L1 on log magnitude, averaged over scales (hop s,
    n_fft 4s, frame 0 kept, the gradient-safe magnitude). ``impl``: "rfft"
    (what "auto" resolves to) or "matmul"."""
    if impl == "auto":
        impl = "rfft"
    if impl == "rfft":
        mag = functools.partial(stft_magnitude, grad_safe=True)
    elif impl == "matmul":
        mag = stft_magnitude_matmul
    else:
        raise ValueError(f"impl must be 'auto', 'rfft' or 'matmul', got {impl!r}")
    x, y = x.float(), y.float()
    loss = 0.0
    for s in scales:
        xs = torch.nan_to_num(mag(x, s * 4, s))
        ys = torch.nan_to_num(mag(y, s * 4, s))
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


def _mean_sq(x: torch.Tensor, count: Optional[int]) -> torch.Tensor:
    """mean(x^2) over the valid positions: ``count`` (the valid positions
    per [batch, channel] of a plane-major fused-MRD map, whose other
    positions are exactly zero) or None (a dense map, the plain mean)."""
    if count is None:
        return torch.mean(x.float() ** 2)
    B, c = x.shape[0], x.shape[1]
    return torch.sum(x.float() ** 2) / (B * c * count)


def _mean_sq_minus1(x: torch.Tensor, count: Optional[int]) -> torch.Tensor:
    """mean((x-1)^2) over the valid positions; each invalid position holds 0
    and adds 1 to the sum, subtracted in closed form."""
    if count is None:
        return torch.mean((x.float() - 1.0) ** 2)
    B, c = x.shape[0], x.shape[1]
    total = x[0, 0].numel()
    s = torch.sum((x.float() - 1.0) ** 2) - B * c * (total - count)
    return s / (B * c * count)


def generator_adversarial_loss(logits: List[torch.Tensor], valid_counts=None) -> torch.Tensor:
    """LSGAN generator loss: fake logits pushed to 0 (the reference's
    inverted labels). ``valid_counts``: per logit, None or the fused MRD's
    valid-position count."""
    counts = valid_counts or [None] * len(logits)
    loss = 0.0
    for logit, cnt in zip(logits, counts):
        loss = loss + _mean_sq(logit, cnt) / len(logits)
    return loss


def discriminator_adversarial_loss(real_logits: List[torch.Tensor],
                                   fake_logits: List[torch.Tensor],
                                   valid_counts=None) -> torch.Tensor:
    """LSGAN discriminator loss: real -> 0, fake -> 1."""
    counts = valid_counts or [None] * len(real_logits)
    loss = 0.0
    for logit, cnt in zip(real_logits, counts):
        loss = loss + _mean_sq(logit, cnt) / len(real_logits)
    for logit, cnt in zip(fake_logits, counts):
        loss = loss + _mean_sq_minus1(logit, cnt) / len(fake_logits)
    return loss


def feature_matching_loss(real_feats: List[torch.Tensor], fake_feats: List[torch.Tensor],
                          valid_counts=None) -> torch.Tensor:
    """L1 between discriminator feature maps; a fused-MRD map holds zeros
    off its valid positions in both operands, so only the divisor changes."""
    counts = valid_counts or [None] * len(real_feats)
    loss = 0.0
    for r, f, cnt in zip(real_feats, fake_feats, counts):
        if cnt is None:
            loss = loss + torch.mean(torch.abs(r - f)) / len(real_feats)
        else:
            B, c = r.shape[0], r.shape[1]
            loss = loss + torch.sum(torch.abs(r.float() - f.float())) / (B * c * cnt) / len(
                real_feats)
    return loss
