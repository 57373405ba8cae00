"""Kernel C: integer-factor linear upsampling (`csrc/resample.cu`).

Replaces `tinyvc_tpu/ops/pallas/resample.py::pallas_upsample_t` on the path
that reaches it, the energy estimator's x64 upsample
(`tinyvc_tpu/dsp/energy.py`). Rows ``[R, T]`` -> ``[R, T*factor]``; unlike
the TPU kernel, the rows are not padded to a multiple of 8 and the output is
exactly ``T*factor`` long.
"""

from __future__ import annotations

import torch

from ..dsp.interp import upsample_time_int_t
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
