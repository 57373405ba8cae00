"""Kernels C, D and J: integer-factor linear resampling and its gradients
(`csrc/resample.cu`).

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

- J, :func:`resample_grad`, replaces `tinyvc_tpu/ops/pallas/resample.py::_up_bwd` and ``_down_bwd``:
  the transposes of C and D; its up mode takes its weights from
  :func:`_grad_tap_table`. :class:`UpsampleVJP` and
  :class:`DownsampleVJP` (:func:`upsample_vjp`, :func:`downsample_vjp`) are
  the training step's differentiable resamples, forward C or D, backward J,
  as the JAX package's ``upsample_vjp`` and ``downsample_vjp``. A bf16
  cotangent (the down path's bf16 activations under bf16 operands) rounds
  the band weights to bf16, as the TPU's band matrix, but not the edge
  corrections, which the TPU applies outside its kernel.
"""

from __future__ import annotations

import functools

import torch

from ..dsp.interp import _tent_weights, downsample_time_int_t, upsample_time_int_t
from . import build

DTYPES = (torch.float32, torch.bfloat16)


def upsample_linear_plain(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain PyTorch version: the tent-filter upsample of `dsp/interp.py`
    (fp32, or bf16 in and out)."""
    return upsample_time_int_t(x, factor)


@functools.lru_cache(maxsize=None)
def _tap_table(factor: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Kernel C's ``[factor, 4]`` fp32 table, phase j's (previous, current,
    next, 0) tap weights: the plain version's (`dsp/interp.py::
    _tent_weights`), rounded to bf16 for a bf16 ``x`` as it rounds them.
    Made once per (factor, dtype, device)."""
    w = torch.from_numpy(_tent_weights(factor)).T
    if dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    return torch.cat([w, w.new_zeros((factor, 1))], 1).contiguous().to(device)


@functools.lru_cache(maxsize=None)
def _grad_tap_table(factor: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Kernel J's ``[2*factor, 4]`` fp32 table for a cotangent of ``dtype``:
    C's table (the band weights, rounded to bf16 for bf16, as
    :func:`upsample_linear_grad_plain` rounds them), then C's fp32 table
    (the clamped edges' weights, never rounded). Made once per (factor,
    dtype, device)."""
    return torch.cat([_tap_table(factor, dtype, device),
                      _tap_table(factor, torch.float32, device)]).contiguous()


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
    build.launch("tvc_upsample_linear", x, x, _tap_table(factor, x.dtype, x.device), out, R, T,
                 factor, int(bf16))
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


def upsample_linear_grad_plain(g: torch.Tensor, T: int, factor: int) -> torch.Tensor:
    """Plain PyTorch version of J's up mode: ``g [R, T*factor]`` -> the
    gradient ``[R, T]`` of :func:`upsample_linear`, written out (the band
    weights in ``g``'s precision, the clamped edges' in fp32)."""
    w = torch.from_numpy(_tent_weights(factor)).to(g.device)
    wb = w.to(torch.bfloat16).float() if g.dtype == torch.bfloat16 else w
    gf = g.float().reshape(g.shape[0], T, factor)
    gx = (gf * wb[1]).sum(-1)
    zero = gx.new_zeros((g.shape[0], 1))
    gx = gx + torch.cat([(gf[:, 1:] * wb[0]).sum(-1), zero], dim=1)
    gx = gx + torch.cat([zero, (gf[:, :-1] * wb[2]).sum(-1)], dim=1)
    edge = torch.zeros_like(gx)
    edge[:, 0] += (gf[:, 0] * w[0]).sum(-1)
    edge[:, -1] += (gf[:, -1] * w[2]).sum(-1)
    return (gx + edge).to(g.dtype)


def downsample_linear_grad_plain(g: torch.Tensor, T: int, factor: int) -> torch.Tensor:
    """Plain PyTorch version of J's down mode: ``g [R, T//factor]`` -> the
    gradient ``[R, T]`` of :func:`downsample_linear`."""
    R, n = g.shape
    gx = g.new_zeros((R, T // factor, factor), dtype=torch.float32)
    if factor % 2:
        gx[..., (factor - 1) // 2] = g.float()
    else:
        gx[..., factor // 2 - 1] = g.float() * 0.5
        gx[..., factor // 2] = g.float() * 0.5
    gx = gx.reshape(R, -1)
    if gx.shape[1] < T:
        gx = torch.cat([gx, gx.new_zeros((R, T - gx.shape[1]))], dim=1)
    return gx.to(g.dtype)


def resample_grad(g: torch.Tensor, T: int, factor: int, up: bool) -> torch.Tensor:
    """The gradient ``[R, T]`` of :func:`upsample_linear` (``up``) or of
    :func:`downsample_linear` for the cotangent ``g`` (``[R, T*factor]`` or
    ``[R, T//factor]``). CPU tensors take the plain versions; CUDA tensors
    launch kernel J."""
    if build.on_cpu(g):
        fn = upsample_linear_grad_plain if up else downsample_linear_grad_plain
        return fn(g, T, factor)
    build.check_input("g", g, 2, DTYPES)
    R, n = g.shape
    if factor < 1 or n != (T * factor if up else T // factor) or (not up and T < factor):
        raise ValueError(f"g {tuple(g.shape)} is not the cotangent of T={T}, factor {factor}")
    gx = torch.empty((R, T), device=g.device, dtype=g.dtype)
    bf16 = g.dtype == torch.bfloat16
    table = _grad_tap_table(factor, g.dtype, g.device) if up else None
    build.launch("tvc_resample_grad", g, g, table, gx, R, T, factor, int(up), int(bf16))
    resample_grad.launches += 1
    resample_grad.launches_bf16 += bf16
    return gx


resample_grad.launches = 0
resample_grad.launches_bf16 = 0  # of them, on bf16 cotangents


class UpsampleVJP(torch.autograd.Function):
    """``[B, C, T]`` -> ``[B, C, T*factor]``: forward C, backward J."""

    @staticmethod
    def forward(ctx, x, factor):
        B, C, T = x.shape
        ctx.shape = (B, C, T, factor)
        return upsample_linear(x.detach().contiguous().reshape(B * C, T), factor).reshape(B, C, -1)

    @staticmethod
    def backward(ctx, g):
        B, C, T, factor = ctx.shape
        gx = resample_grad(g.contiguous().reshape(B * C, -1), T, factor, True)
        return gx.reshape(B, C, T), None


class DownsampleVJP(torch.autograd.Function):
    """``[B, C, T]`` -> ``[B, C, T//factor]``: forward D, backward J."""

    @staticmethod
    def forward(ctx, x, factor):
        B, C, T = x.shape
        ctx.shape = (B, C, T, factor)
        return downsample_linear(x.detach().contiguous().reshape(B * C, T),
                                 factor).reshape(B, C, -1)

    @staticmethod
    def backward(ctx, g):
        B, C, T, factor = ctx.shape
        gx = resample_grad(g.contiguous().reshape(B * C, -1), T, factor, False)
        return gx.reshape(B, C, T), None


def upsample_vjp(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Differentiable upsampling of ``[B, C, T]`` (the JAX package's
    ``upsample_vjp`` with ``out_len = T*factor``)."""
    return UpsampleVJP.apply(x, factor)


def downsample_vjp(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Differentiable decimation of ``[B, C, T]`` to ``T//factor``."""
    return DownsampleVJP.apply(x, factor)
