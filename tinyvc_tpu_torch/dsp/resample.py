"""Polyphase sample-rate conversion (counterpart of `tinyvc_tpu/dsp/resample.py`).

A windowed-sinc low-pass at the rational ratio new/orig, torchaudio's
construction (``lowpass_filter_width=6``, rolloff 0.99, the squared-cosine
window): the ``new`` phases of the filter bank are the output channels of
one strided ``F.conv1d`` whose stride is ``orig``. The JAX package computes
the same conv with XLA, outside any Pallas kernel, so a library conv is its
counterpart here. The conv runs with TF32 off (`infer/generator.py::
exact_fp32`), as the rest of the fp32 path does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
            rolloff: float = 0.99):
    """(filter bank ``[new, width]`` float32 numpy, orig, new, width), built
    in float64 exactly as the JAX package builds it, and cached."""
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd
    width = int(math.ceil(lowpass_filter_width * orig / (min(orig, new) * rolloff)))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    cutoff = min(orig, new) * rolloff / 2.0
    t = t * 2 * cutoff
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = 2 * cutoff / orig
    with np.errstate(invalid="ignore"):
        sinc = np.where(t == 0, 1.0, np.sin(np.pi * t) / (np.pi * t))
    kernels = sinc * window * scale
    return kernels.astype(np.float32), orig, new, width


@functools.lru_cache(maxsize=None)
def _weight(orig_freq: int, new_freq: int, device: torch.device) -> torch.Tensor:
    """:func:`_kernel`'s bank as a conv weight ``[new, 1, width]`` on
    ``device``, copied there once (a normal tensor, usable in and out of
    inference mode)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_kernel(orig_freq, new_freq)[0])[:, None, :].to(device)


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """``x`` ``[..., T]`` -> ``[..., ceil(T * new / orig)]`` on ``x``'s
    device, in ``x``'s dtype (computed in fp32)."""
    if orig_freq == new_freq:
        return x
    from ..infer.generator import exact_fp32

    _, orig, new, width = _kernel(orig_freq, new_freq)
    shape = x.shape
    T = shape[-1]
    x2 = F.pad(x.reshape(-1, T).float(), (width, width + orig))
    with exact_fp32():
        y = F.conv1d(x2[:, None, :], _weight(orig_freq, new_freq, x.device), stride=orig)
    y = y.transpose(1, 2).reshape(x2.shape[0], -1)  # [B, new, n] -> phases interleaved
    target_len = int(math.ceil(T * new / orig))
    return y[:, :target_len].reshape(*shape[:-1], target_len).to(x.dtype)
