"""The fused U-Net of the serving path (counterpart of
`tinyvc_tpu/ops/fused_filternet.py::filternet_fused_apply`, its serving
branch: channels-first, prepacked source, no gradient).

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
"""

from __future__ import annotations

import torch

from ..config import DecoderConfig
from ..kernels.filter_stage import conv3, downsample_chain, upsample_chain
from ..kernels.resample import downsample_linear, upsample_linear
from ..models.decoder import FilterNet, _log_f0_feature, compute_dtype
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
) -> torch.Tensor:
    """content ``[B, F, C]``, f0 ``[B, F]``, energy ``[B, L]`` and the packed
    source ``[B, pack_width, L]`` (harmonics, noise, energy, zero rows;
    `models/decoder.py::Decoder.dsp`) -> waveform ``[B, L]``."""
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
    for wd, f in zip(w.down, reversed(factors[1:])):
        src = downsample_chain(_resample(downsample_linear, src, f), *wd)
        skips.append(src)
    n_up = len(factors)
    for i, (wu, f) in enumerate(zip(w.up, factors)):
        cond = skips[len(skips) - 1 - i]
        xu = _resample(upsample_linear, x, f)
        if i == n_up - 1:
            wconv, bconv, wfilm, bfilm, w5c, b5c, bout = wu
            x = upsample_chain(xu, cond, wconv, bconv, wfilm, bfilm, w5c, b5c,
                               fold_k=w5c.shape[0], bout=bout)
        else:
            x = upsample_chain(xu, cond, *wu, out_dtype=dt)
    return x[:, 0, :]
