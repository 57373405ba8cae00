"""Waveform energy (counterpart of `tinyvc_tpu/dsp/energy.py`).

``max_pool1d(|x|, kernel=2*frame, stride=frame, padding=frame//2)`` followed
by linear upsampling back to the waveform length. At an integer factor, as on
the conversion path (x64), the upsample is kernel C
(`kernels/resample.py`), which replaces the TPU's banded-matmul kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.resample import upsample_linear
from .interp import linear_interp_last


def estimate_energy(wave: torch.Tensor, frame_size: int = 64) -> torch.Tensor:
    """wave ``[B, L]`` -> energy ``[B, L]`` (sample rate, max-pooled)."""
    L = wave.shape[-1]
    pooled = F.max_pool1d(
        wave.abs()[:, None, :], 2 * frame_size, frame_size, frame_size // 2
    )[:, 0]
    P = pooled.shape[-1]
    if L % P == 0:
        return upsample_linear(pooled.contiguous(), L // P)
    return linear_interp_last(pooled, L)
