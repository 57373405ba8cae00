"""Pitch shift (counterpart of `tinyvc_tpu/dsp/pitch.py`)."""

from __future__ import annotations

import torch


def frequency_to_midi(f: torch.Tensor) -> torch.Tensor:
    return torch.log2((f / 440.0).clamp_min(0.0) + 1e-6) * 12.0 + 69.0


def midi_to_frequency(n: torch.Tensor) -> torch.Tensor:
    return 440.0 * torch.pow(2.0, (n - 69.0) / 12.0)


def shift_frequency(f0: torch.Tensor, shift: float) -> torch.Tensor:
    """Shift f0 by ``shift`` semitones (12 = one octave)."""
    return midi_to_frequency(frequency_to_midi(f0) + shift)
