"""Kernels C and D: integer-factor linear resampling (`csrc/resample.cu`).

- C, :func:`upsample_linear`, replaces
  `tinyvc_tpu/ops/pallas/resample.py::pallas_upsample_t` on the paths that
  reach it: the energy estimator's x64 upsample (`dsp/energy.py`) and the
  fused U-Net's five up stages (`ops/fused_filternet.py`, factors 2, 3, 4,
  4, 5 on ``B*C`` rows).
- D, :func:`downsample_linear`, replaces
  `tinyvc_tpu/ops/pallas/resample.py::pallas_downsample_t`: the fused
  U-Net's four decimations (factors 5, 4, 4, 3 on ``B*C`` rows).

Rows ``[R, T]``; unlike the TPU kernels, the rows are not padded to a
multiple of 8 and the output is exactly ``T*factor`` (C) or ``T//factor``
(D) long. The JAX package lowers the U-Net's short resamples (under 8192
samples) to an XLA tent conv instead of its kernels; that is a lowering
choice of the TPU, the function is the same, and here every resample of a
CUDA tensor goes through C or D.
"""

from __future__ import annotations

import torch

from ..dsp.interp import downsample_time_int_t, upsample_time_int_t
from . import build


def upsample_linear_plain(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain PyTorch version: the tent-filter upsample of `dsp/interp.py`."""
    return upsample_time_int_t(x, factor)


def upsample_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[R, T]`` -> ``[R, T*factor]`` linear upsampling (align_corners=False,
    edge clamp). CPU tensors take the plain version; CUDA tensors launch
    kernel C."""
    if build.on_cpu(x):
        return upsample_linear_plain(x, factor)
    build.check_input("x", x, 2)
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    R, T = x.shape
    out = torch.empty((R, T * factor), device=x.device, dtype=torch.float32)
    rc = build.library().tvc_upsample_linear(
        x.data_ptr(), out.data_ptr(), R, T, factor, build.stream_of(x)
    )
    build.check_status(rc, "tvc_upsample_linear")
    upsample_linear.launches += 1
    return out


upsample_linear.launches = 0


def downsample_linear_plain(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain PyTorch version: the decimation of `dsp/interp.py`."""
    return downsample_time_int_t(x, factor)


def downsample_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[R, T]`` -> ``[R, T//factor]`` linear downsampling (align_corners=
    False): the centre sample of each block of ``factor`` for odd factors,
    the mean of the two centre samples for even ones. CPU tensors take the
    plain version; CUDA tensors launch kernel D."""
    if build.on_cpu(x):
        return downsample_linear_plain(x, factor)
    build.check_input("x", x, 2)
    R, T = x.shape
    if factor < 1 or T < factor:
        raise ValueError(f"factor must be in [1, {T}], got {factor}")
    out = torch.empty((R, T // factor), device=x.device, dtype=torch.float32)
    rc = build.library().tvc_downsample_linear(
        x.data_ptr(), out.data_ptr(), R, T, factor, build.stream_of(x)
    )
    build.check_status(rc, "tvc_downsample_linear")
    downsample_linear.launches += 1
    return out


downsample_linear.launches = 0
