"""The fused U-Net (counterpart of
`tinyvc_tpu/ops/fused_filternet.py::filternet_fused_apply`): the serving
branch (:func:`filternet_fused_apply`: channels-first, prepacked source, no
gradient) and the training step's ``differentiable=True`` branch
(:func:`filternet_fused_train`).

The frame-rate dense layers run as torch calls; every waveform-rate step is
a kernel of `kernels/`: the stem (E, stem mode), four times a decimation
(D) and a Downsample chain (E), five times an interpolation (C) and an
Upsample chain (F), the last with the k=7 output conv folded in. The chains
edge-replicate their input where the layer-by-layer U-Net
(`models/decoder.py::FilterNet`) replicate-pads each conv, so the two differ
near the utterance's ends; compare fused with fused.

Under ``compute_dtype="bfloat16"`` (the serving profile) it follows the JAX
function's bf16 branch: the frame-rate denses take bf16 operands with an
fp32 sum and bias and store bf16 (`fused_filternet.py:36-40`); the packed
source is cast to bf16 (`:133`); every resample and chain runs on bf16
tensors (kernels C-F in bf16); each stage's output is stored in bf16, the
up chains' by the kernel as it writes (`:317-322`); the folded last stage
returns fp32 (`:323`).

The differentiable branch routes each stage as the JAX package does
(`fused_filternet.py:160-323`): the stem, and the Downsample and Upsample
chains whose time axis is at least 1024 long and whose input has at most 96
channels (``_diff_kernel_ok``), run as autograd Functions over the kernels
(stem and down chains: E forward, L backward; up chains: F forward, K
backward; the last, with the k=7 output conv folded in, always), the
resamples whose long side is at least 8192 samples as C or D forward and J
backward; the deep, frame-rate stages run the layer-by-layer modules'
bodies, and the short resamples the tent filter of `dsp/interp.py`, under
autograd, where the JAX package leaves both to XLA. Operands are bf16
(``dtype_name="bfloat16"``, the TPU's choice in training) or fp32; the
stem's and the down chains' outputs are stored in the operands' dtype, the
up chains' in fp32.
"""

from __future__ import annotations

import torch

from typing import Optional

from ..config import DecoderConfig
from ..dsp.interp import downsample_time_int_t, upsample_time_int_t
from ..kernels.filter_stage import (conv3, down_chain_vjp, downsample_chain, stem_conv_vjp,
                                    up_chain_vjp, upsample_chain)
from ..kernels.resample import downsample_linear, downsample_vjp, upsample_linear, upsample_vjp
from ..models.decoder import FilterNet, _log_f0_feature, compute_dtype, fused_pack_width
from ..models.layers import Dense
from ..utils.weights import FusedFilterWeights, pack_filter_net


def fused_weights(net: FilterNet, pack_width: int) -> FusedFilterWeights:
    """``net``'s packed weights, built at the first fused call and kept on
    the module; built again only when a parameter was replaced, moved or
    written in place (its data pointer or version counter changed)."""
    key = (pack_width,) + tuple((p.data_ptr(), 0 if p.is_inference() else p._version)
                                for p in net.parameters())
    cached = getattr(net, "_fused_cache", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_filter_net(net, pack_width))
        net._fused_cache = cached
    return cached[1]


def _dense(x: torch.Tensor, dense: Dense, dt: torch.dtype) -> torch.Tensor:
    """``dense(x)`` with the JAX function's ``_dense``: operands in ``dt``,
    the product rounded to ``dt``, the bias added in fp32, stored in ``dt``."""
    if dt == torch.float32:
        return dense(x)
    y = torch.matmul(x.to(dt), dense.weight.to(dt).T).float()
    return (y + dense.bias).to(dt)


def _resample(fn, x: torch.Tensor, factor: int) -> torch.Tensor:
    """Apply a rows resampler (kernel C or D) to ``[B, C, T]``."""
    B, C, T = x.shape
    return fn(x.reshape(B * C, T), factor).reshape(B, C, -1)


def filternet_fused_apply(
    net: FilterNet,
    cfg: DecoderConfig,
    content: torch.Tensor,
    f0: torch.Tensor,
    energy: torch.Tensor,
    source_packed: torch.Tensor,
    kernel_min_len: int = 0,
) -> torch.Tensor:
    """content ``[B, F, C]``, f0 ``[B, F]``, energy ``[B, L]`` and the packed
    source ``[B, pack_width, L]`` (harmonics, noise, energy, zero rows;
    `models/decoder.py::Decoder.dsp`) -> waveform ``[B, L]``.

    ``kernel_min_len``: a Downsample or Upsample stage whose time axis is
    shorter runs the layer-by-layer module's body instead of its chain
    kernel (E or F), and a last stage so short its module and the separate
    k=7 output conv; the resamples stay kernels C and D. Chunked conversion
    passes 8192, as the JAX package's does (`tinyvc_tpu/parallel/
    time_shard.py:473-481`, `fused_filternet.py:226-236,271-284`): the
    modules replicate-pad each conv where the chains edge-replicate their
    input, so this changes the result, not only the route."""
    B, pack_width, L = source_packed.shape
    if energy.shape != (B, L):
        raise ValueError(f"energy {tuple(energy.shape)} does not match the source {(B, L)}")
    w = fused_weights(net, pack_width)
    factors = list(cfg.filter_factors)
    dt = compute_dtype(cfg.compute_dtype)

    x = _dense(content, net.content_in, dt) + _dense(_log_f0_feature(f0), net.f0_in, dt)
    x = x.transpose(1, 2).contiguous()
    src = conv3(source_packed.to(dt).contiguous(), *w.stem)
    skips = [src]
    for i, (wd, f) in enumerate(zip(w.down, reversed(factors[1:]))):
        z = _resample(downsample_linear, src, f)
        if z.shape[2] < kernel_min_len:
            src = getattr(net, f"down_{i + 1}").body(z).to(dt)
        else:
            src = downsample_chain(z, *wd)
        skips.append(src)
    n_up = len(factors)
    for i, (wu, f) in enumerate(zip(w.up, factors)):
        cond = skips[len(skips) - 1 - i]
        xu = _resample(upsample_linear, x, f)
        if cond.shape[2] < kernel_min_len:
            x = getattr(net, f"up_{i}").body(xu, cond).to(dt)
            if i == n_up - 1:
                x = net.output_layer(x.float())
        elif i == n_up - 1:
            wconv, bconv, wfilm, bfilm, w5c, b5c, bout = wu
            x = upsample_chain(xu, cond, wconv, bconv, wfilm, bfilm, w5c, b5c,
                               fold_k=w5c.shape[0], bout=bout)
        else:
            x = upsample_chain(xu, cond, *wu, out_dtype=dt)
    return x[:, 0, :]


KERNEL_RESAMPLE_LEN = 8192  # JAX's gate for the kernel resamples in training


def _diff_kernel_ok(c_in: int, T: int) -> bool:
    """JAX's gate for the chain kernels in training (`fused_filternet.py:169`)."""
    return T >= 1024 and c_in <= 96


def filternet_fused_train(
    net: FilterNet,
    cfg: DecoderConfig,
    content: torch.Tensor,
    f0: torch.Tensor,
    energy: torch.Tensor,
    source: torch.Tensor,
    dtype_name: Optional[str] = None,
) -> torch.Tensor:
    """The differentiable fused U-Net: content ``[B, F, C]``, f0 ``[B, F]``,
    energy ``[B, L]`` and the source ``[B, H+2, L]`` (channels-first) ->
    waveform ``[B, L]`` fp32, differentiable in ``net``'s parameters and the
    source. ``dtype_name`` ("bfloat16" or "float32", default
    ``cfg.compute_dtype``) is the operands' precision."""
    B, n_src, L = source.shape
    dt = compute_dtype(cfg.compute_dtype)
    bf16 = compute_dtype(dtype_name or cfg.compute_dtype) == torch.bfloat16
    factors = list(cfg.filter_factors)
    channels = list(cfg.filter_channels)

    x = _dense(content, net.content_in, dt) + _dense(_log_f0_feature(f0), net.f0_in, dt)
    npad = fused_pack_width(n_src) - n_src - 1
    src = torch.cat([source.to(dt), energy[:, None, :].to(dt), source.new_zeros((B, npad, L)).to(dt)],
                    dim=1)
    w = pack_filter_net(net, src.shape[1], grad=True)
    src = stem_conv_vjp(src, *w.stem, bf16)
    skips = [src]
    ns = list(reversed(channels[1:]))[1:] + [channels[0]]
    cur_len = L
    for i, (n, f, wd) in enumerate(zip(ns, reversed(factors[1:]), w.down)):
        cur_len //= f
        if cur_len * f >= KERNEL_RESAMPLE_LEN:
            z = downsample_vjp(src, f)
        else:
            z = downsample_time_int_t(src, f)
        if _diff_kernel_ok(max(z.shape[1], n), cur_len):
            src = down_chain_vjp(z, *wd, bf16)
        else:
            src = getattr(net, f"down_{i + 1}").body(z.to(dt))
        skips.append(src)

    x = x.transpose(1, 2)
    n_up = len(factors)
    for i, (wu, f) in enumerate(zip(w.up, factors)):
        cond = skips[len(skips) - 1 - i]
        c_in = x.shape[1]
        if cond.shape[2] >= KERNEL_RESAMPLE_LEN:
            xu = upsample_vjp(x, f)
        else:
            xu = upsample_time_int_t(x, f)
        if i == n_up - 1:
            wconv, bconv, wfilm, bfilm, w5c, b5c, bout = wu
            x = up_chain_vjp(xu, cond, wconv, bconv, wfilm, bfilm, w5c, b5c, bout,
                             w5c.shape[0], bf16)
        elif _diff_kernel_ok(c_in, xu.shape[2]):
            x = up_chain_vjp(xu, cond, *wu, None, 0, bf16).to(dt)
        else:
            x = getattr(net, f"up_{i}").body(xu, cond.to(dt)).to(dt)
    return x[:, 0, :].float()
