"""Linear resampling along time (counterpart of `tinyvc_tpu/dsp/interp.py`).

Semantics of ``F.interpolate(mode='linear', align_corners=False)``: output
sample ``i`` reads input coordinate ``(i + 0.5) * Li / Lo - 0.5``, clamped to
``[0, Li - 1]``. The port never calls ``F.interpolate``; these are gathers
and fixed-weight sums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _source_coords(in_len: int, out_len: int, device):
    """(left index, right index, fraction) of each output sample."""
    scale = in_len / out_len
    i = torch.arange(out_len, dtype=torch.float32, device=device)
    src = ((i + 0.5) * scale - 0.5).clamp(0.0, float(in_len - 1))
    idx0 = torch.floor(src)
    frac = src - idx0
    idx0 = idx0.long()
    return idx0, (idx0 + 1).clamp_max(in_len - 1), frac


def linear_interp_last(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resample the last axis of ``x`` to ``out_len`` samples."""
    in_len = x.shape[-1]
    if in_len == out_len:
        return x
    idx0, idx1, frac = _source_coords(in_len, out_len, x.device)
    frac = frac.to(x.dtype)
    return x[..., idx0] * (1.0 - frac) + x[..., idx1] * frac


def linear_interp_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resample axis -2 (time in ``[B, T, C]``) to ``out_len`` samples."""
    in_len = x.shape[-2]
    if in_len == out_len:
        return x
    idx0, idx1, frac = _source_coords(in_len, out_len, x.device)
    frac = frac.to(x.dtype)[:, None]
    return x[..., idx0, :] * (1.0 - frac) + x[..., idx1, :] * frac


def upsample_frames_to_samples(x: torch.Tensor, frame_size: int) -> torch.Tensor:
    """Frame-rate ``[B, F, C]`` -> sample-rate ``[B, F*frame_size, C]``."""
    y = linear_interp_last(x.transpose(1, 2), x.shape[1] * frame_size)
    return y.transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _tent_weights(f: int) -> np.ndarray:
    """``[3, f]`` weights of the (previous, current, next) input sample for
    output phase ``j`` of an integer-factor ``f`` linear upsample."""
    a = (np.arange(f) + 0.5) / f - 0.5
    return np.stack(
        [np.maximum(-a, 0.0), 1.0 - np.abs(a), np.maximum(a, 0.0)]
    ).astype(np.float32)


def upsample_time_int_t(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[..., T]`` -> ``[..., T*factor]``: integer-factor linear upsampling
    (the tent filter of `tinyvc_tpu/dsp/interp.py::upsample_time_int_t`)
    with the edge clamp. A bf16 ``x`` gets bf16-rounded weights, as the JAX
    function casts its kernel to ``x.dtype``; the products (exact) and the
    sum are fp32, the result bf16."""
    if factor == 1:
        return x
    w = torch.from_numpy(_tent_weights(factor)).to(x.device)
    out_dtype = x.dtype
    if x.dtype == torch.bfloat16:
        w, x = w.to(torch.bfloat16).float(), x.float()
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)[..., None]
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)[..., None]
    y = prev * w[0] + x[..., None] * w[1] + nxt * w[2]
    return y.reshape(*x.shape[:-1], x.shape[-1] * factor).to(out_dtype)


def downsample_time_int_t(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[..., T]`` -> ``[..., T//factor]``: integer-factor linear
    downsampling (centre sample for odd factors, mean of the two centre
    samples for even ones, in fp32 for a bf16 ``x``)."""
    if factor == 1:
        return x
    T = x.shape[-1] // factor
    blocks = x[..., : T * factor].reshape(*x.shape[:-1], T, factor)
    if factor % 2:
        return blocks[..., (factor - 1) // 2]
    c = factor // 2 - 1
    a, b = blocks[..., c].float(), blocks[..., c + 1].float()
    return (a * 0.5 + b * 0.5).to(x.dtype)
