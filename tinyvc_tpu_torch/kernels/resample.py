"""Kernels C and D: integer-factor linear resampling (`csrc/resample.cu`).

- C, :func:`upsample_linear`, replaces
  `tinyvc_tpu/ops/pallas/resample.py::pallas_upsample_t` on the paths that
  reach it: the energy estimator's x64 upsample (`dsp/energy.py`) and the
  fused U-Net's five up stages (`ops/fused_filternet.py`, factors 2, 3, 4,
  4, 5 on ``B*C`` rows).
- D, :func:`downsample_linear`, replaces
  `tinyvc_tpu/ops/pallas/resample.py::pallas_downsample_t`: the fused
  U-Net's four decimations (factors 5, 4, 4, 3 on ``B*C`` rows).

Rows ``[R, T]`` in fp32, or in bf16 under the serving profile: then the
output is bf16 too, C's tap weights are rounded to bf16 as the TPU kernel's
band matrix is (`resample.py:116`), and products and sums are fp32. The
energy upsample stays fp32. Unlike the TPU kernels, the rows are not
padded to a multiple of 8 and the output is exactly ``T*factor`` (C) or
``T//factor`` (D) long. The JAX package lowers the U-Net's short resamples (under 8192
samples) to an XLA tent conv instead of its kernels; that is a lowering
choice of the TPU, the function is the same, and here every resample of a
CUDA tensor goes through C or D.
"""

from __future__ import annotations

import torch

from ..dsp.interp import downsample_time_int_t, upsample_time_int_t
from . import build

DTYPES = (torch.float32, torch.bfloat16)


def upsample_linear_plain(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain PyTorch version: the tent-filter upsample of `dsp/interp.py`
    (fp32, or bf16 in and out)."""
    return upsample_time_int_t(x, factor)


def upsample_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[R, T]`` -> ``[R, T*factor]`` linear upsampling (align_corners=False,
    edge clamp). CPU tensors take the plain version; CUDA tensors launch
    kernel C."""
    if build.on_cpu(x):
        return upsample_linear_plain(x, factor)
    build.check_input("x", x, 2, DTYPES)
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    R, T = x.shape
    out = torch.empty((R, T * factor), device=x.device, dtype=x.dtype)
    bf16 = x.dtype == torch.bfloat16
    build.launch("tvc_upsample_linear", x, x, out, R, T, factor, int(bf16))
    upsample_linear.launches += 1
    upsample_linear.launches_bf16 += bf16
    return out


upsample_linear.launches = 0
upsample_linear.launches_bf16 = 0  # of them, on bf16 inputs


def downsample_linear_plain(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain PyTorch version: the decimation of `dsp/interp.py` (fp32, or
    bf16 in and out)."""
    return downsample_time_int_t(x, factor)


def downsample_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[R, T]`` -> ``[R, T//factor]`` linear downsampling (align_corners=
    False): the centre sample of each block of ``factor`` for odd factors,
    the mean of the two centre samples for even ones. CPU tensors take the
    plain version; CUDA tensors launch kernel D."""
    if build.on_cpu(x):
        return downsample_linear_plain(x, factor)
    build.check_input("x", x, 2, DTYPES)
    R, T = x.shape
    if factor < 1 or T < factor:
        raise ValueError(f"factor must be in [1, {T}], got {factor}")
    out = torch.empty((R, T // factor), device=x.device, dtype=x.dtype)
    bf16 = x.dtype == torch.bfloat16
    build.launch("tvc_downsample_linear", x, x, out, R, T, factor, int(bf16))
    downsample_linear.launches += 1
    downsample_linear.launches_bf16 += bf16
    return out


downsample_linear.launches = 0
downsample_linear.launches_bf16 = 0  # of them, on bf16 inputs
