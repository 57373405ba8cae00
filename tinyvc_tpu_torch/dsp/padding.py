"""Waveform padding (counterpart of `tinyvc_tpu/dsp/padding.py`).

The bucket padding is part of the result, not only of the compile cache:
GRN (`models/layers.py::GRN`) normalises over the whole time axis, so the
zeros appended here change every output frame. The port pads exactly as the
JAX package does, to multiples of 64 frames.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def autopad_waveform(wave: torch.Tensor, frame_size: int = 480) -> torch.Tensor:
    """Zero-pad ``[B, L]`` so that L is a multiple of ``frame_size``."""
    pad = (-wave.shape[-1]) % frame_size
    return F.pad(wave, (0, pad)) if pad else wave


def bucket_length(length: int, frame_size: int = 480, bucket_frames: int = 64) -> int:
    """Smallest multiple of ``frame_size * bucket_frames`` >= length."""
    step = frame_size * bucket_frames
    return int(-(-length // step) * step)


def pad_to_bucket(
    wave: np.ndarray, frame_size: int = 480, bucket_frames: int = 64
) -> tuple[np.ndarray, int]:
    """Host-side: zero-pad ``[B, L]`` to its bucket; returns (padded, L)."""
    L = wave.shape[-1]
    target = bucket_length(L, frame_size, bucket_frames)
    if target != L:
        wave = np.pad(wave, [(0, 0)] * (wave.ndim - 1) + [(0, target - L)])
    return wave, L
