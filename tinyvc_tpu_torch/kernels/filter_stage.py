"""Kernels E and F: the fused U-Net's conv chains (`csrc/filter_stage.cu`).

- E replaces `tinyvc_tpu/ops/pallas/filter_stage.py::_run_down_kernel`:
  :func:`downsample_chain` (``fused_downsample_chain_t``, one Downsample
  body after its decimation) and, in stem mode, :func:`conv3`
  (``fused_conv3_t``, the k=3 stem over the packed source).
- F replaces ``fused_upsample_chain_t`` (``_kernel``, ``_kernel_stream``,
  ``_chain``): :func:`upsample_chain`, one Upsample body after its
  interpolation, with the model's k=7 output conv folded into the last stage
  (``fold_k=7``).

The weights come in the JAX package's packed layouts
(`utils/weights.py`): a k=3 conv as ``[Co, 3*Cin]`` tap-major (taps t-d, t,
t+d), biases as ``[C, 1]``, the up chain's four convs stacked ``[4, C, 3C]``
and its two FiLMs as ``[4C, C]`` rows (scale1 | shift1 | scale2 | shift2).

The TPU kernels fill their halos with the edge-replicated chain *input* and
pad no conv on its own, so each chain is exactly: pad the input by edge
replication by the chain's receptive field R, run every conv "valid", crop.
The plain versions below are that; the layer-by-layer U-Net
(`models/decoder.py`) replicate-pads every conv instead and differs within
~R samples of the utterance's ends. The input may be longer than the time
axis the chain serves (the untrimmed interpolation or decimation output);
only its first ``T`` samples are read.

Precision follows the chain input's dtype. fp32 is the JAX package's fp32
profile. bf16 is the serving profile (``dtype_name="bfloat16"``,
`ops/pallas/filter_stage.py::_conv_cf`, ``_chain``, ``_chain_down``): the
chain input and ``cond`` are bf16; every conv, FiLM and 1x1 product takes
bf16 operands (the fp32 activation and the fp32 weights rounded to bf16 as
they enter it) with fp32 accumulation; leaky ReLU, biases, FiLM, residuals
and the folded output conv stay fp32. E returns bf16, F fp32 (or bf16 with
``out_dtype``, which rounds as a cast after it would).

CPU tensors take the plain versions; CUDA tensors launch the kernels, or
raise. Each wrapper counts its calls that launched (``launches``); one call
is 1 CUDA launch for the stem, 3 for a down chain and 5 for an up chain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import build

DILATIONS_UP = (1, 3, 9, 27)
DILATIONS_DOWN = (1, 2, 4)
R_UP = sum(DILATIONS_UP)  # 40, the up chain's reach on each side
R_DOWN = sum(DILATIONS_DOWN)  # 7
DTYPES = (torch.float32, torch.bfloat16)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _operand(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``t`` as a product operand: rounded to bf16 (and kept in fp32, where
    a product of two such values is exact) under bf16, else as it is."""
    return t.to(torch.bfloat16).float() if bf16 else t


def _conv_valid(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int,
                bf16: bool = False) -> torch.Tensor:
    """Unpadded dilated conv of ``[B, Cin, T]`` with packed ``w [Co, K*Cin]``,
    on bf16-rounded operands under ``bf16``; fp32 sums."""
    co, cin = w.shape[0], x.shape[1]
    weight = _operand(w, bf16).reshape(co, -1, cin).transpose(1, 2)
    return F.conv1d(_operand(x, bf16), weight, b.reshape(-1), dilation=d)


def _edge_pad(x: torch.Tensor, T: int, r: int) -> torch.Tensor:
    return F.pad(x[..., :T], (r, r), mode="replicate")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def conv3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stem: ``[B, Cin, T]`` -> ``[B, Co, T]`` (in ``x``'s dtype), one
    k=3 conv with ``w [Co, 3*Cin]``."""
    bf16 = x.dtype == torch.bfloat16
    y = _conv_valid(_edge_pad(x.float(), x.shape[-1], 1), w, b, 1, bf16)
    return y.to(x.dtype)


def downsample_chain_plain(
    z: torch.Tensor, wres, bres, w1, b1, w2, b2, w3, b3, out_len: Optional[int] = None,
) -> torch.Tensor:
    """One Downsample body: ``[B, Cin, >=T]`` -> ``[B, Co, T]`` (in ``z``'s
    dtype): ``1x1(z) + conv_d4(lrelu(conv_d2(lrelu(conv_d1(lrelu(z))))))``."""
    bf16 = z.dtype == torch.bfloat16
    T = z.shape[-1] if out_len is None else out_len
    x = _edge_pad(z.float(), T, R_DOWN)
    res = torch.matmul(_operand(wres, bf16), x[..., R_DOWN:R_DOWN + T]) + bres
    h = x
    for w, b, d in zip((w1, w2, w3), (b1, b2, b3), DILATIONS_DOWN):
        h = _conv_valid(_lrelu(h), w, b, d, bf16)
    return (h + res).to(z.dtype)


def upsample_chain_plain(
    xu: torch.Tensor, cond: torch.Tensor, wconv, bconv, wfilm, bfilm, w5, b5,
    fold_k: int = 0, bout: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One Upsample body: ``xu [B, C, >=T]``, ``cond [B, C, T]`` ->
    ``[B, Co, T]``, or ``[B, 1, T]`` with ``fold_k`` (then ``w5 [k, C]``,
    ``b5 [k, 1]`` are the folded output-conv weights and ``bout [1, 1]`` its
    bias, and the product is fp32 also under bf16)."""
    bf16 = xu.dtype == torch.bfloat16
    B, C, T = cond.shape
    half = (fold_k - 1) // 2 if fold_k else 0
    R = R_UP + half
    x = _edge_pad(xu.float(), T, R)
    films = torch.matmul(_operand(wfilm, bf16), _edge_pad(cond.float(), T, R)) + bfilm

    def film(h, off, j, res):
        n = h.shape[-1]
        return (h * films[:, 2 * j * C:(2 * j + 1) * C, off:off + n]
                + films[:, (2 * j + 1) * C:(2 * j + 2) * C, off:off + n] + res[..., :n])

    h = _conv_valid(_lrelu(x), wconv[0], bconv[0], 1, bf16)  # columns from 1
    h = _conv_valid(_lrelu(h), wconv[1], bconv[1], 3, bf16)  # from 4
    h = film(h, 4, 0, x[..., 4:])
    res = h
    h = _conv_valid(_lrelu(h), wconv[2], bconv[2], 9, bf16)  # from 13
    h = _conv_valid(_lrelu(h), wconv[3], bconv[3], 27, bf16)  # from 40
    h = film(h, R_UP, 1, res[..., R_UP - 4:])
    if not fold_k:
        # columns [40, 40 + T): exactly [0, T)
        return (torch.matmul(_operand(w5, bf16), _operand(h, bf16)) + b5).to(out_dtype)
    p = torch.matmul(w5, h) + b5
    # folded output conv: out[t] = sum_j p[j, t + j - half], p from column 40
    out = p[:, 0:1, 0:T]
    for j in range(1, fold_k):
        out = out + p[:, j:j + 1, j:j + T]
    return out + bout


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_weights(**weights: torch.Tensor) -> None:
    for name, t in weights.items():
        build.check_input(name, t, t.dim())


def _check_shape(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stem (kernel E, stem mode): ``[B, Cin, T]`` -> ``[B, Co, T]``,
    fp32 or bf16 in and out."""
    if build.on_cpu(x, w, b):
        return conv3_plain(x, w, b)
    build.check_input("x", x, 3, DTYPES)
    _check_weights(w=w, b=b)
    B, cin, T = x.shape
    co = w.shape[0]
    _check_shape("w", w, (co, 3 * cin))
    _check_shape("b", b, (co, 1))
    out = torch.empty((B, co, T), device=x.device, dtype=x.dtype)
    bf16 = x.dtype == torch.bfloat16
    build.launch("tvc_conv3", x, x, w, b, out, B, cin, co, T, T, int(bf16))
    conv3.launches += 1
    conv3.launches_bf16 += bf16
    return out


conv3.launches = 0
conv3.launches_bf16 = 0  # of them, on bf16 inputs


def downsample_chain(
    z: torch.Tensor, wres, bres, w1, b1, w2, b2, w3, b3, out_len: Optional[int] = None,
) -> torch.Tensor:
    """One Downsample body (kernel E): ``[B, Cin, >=T]`` -> ``[B, Co, T]``,
    fp32 or bf16 in and out."""
    ws = dict(wres=wres, bres=bres, w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
    if build.on_cpu(z, *ws.values()):
        return downsample_chain_plain(z, wres, bres, w1, b1, w2, b2, w3, b3, out_len)
    build.check_input("z", z, 3, DTYPES)
    _check_weights(**ws)
    B, cin, Tz = z.shape
    T = Tz if out_len is None else out_len
    if not 0 < T <= Tz:
        raise ValueError(f"out_len {T} outside (0, {Tz}]")
    co = wres.shape[0]
    for name, shape in (("wres", (co, cin)), ("bres", (co, 1)), ("w1", (cin, 3 * cin)),
                        ("b1", (cin, 1)), ("w2", (cin, 3 * cin)), ("b2", (cin, 1)),
                        ("w3", (co, 3 * cin)), ("b3", (co, 1))):
        _check_shape(name, ws[name], shape)
    out = torch.empty((B, co, T), device=z.device, dtype=z.dtype)
    work = torch.empty((2, B, cin, T + 2 * R_DOWN), device=z.device, dtype=torch.float32)
    bf16 = z.dtype == torch.bfloat16
    build.launch("tvc_down_chain", z, z, *ws.values(), out, work, B, cin, co, T, Tz, int(bf16))
    downsample_chain.launches += 1
    downsample_chain.launches_bf16 += bf16
    return out


downsample_chain.launches = 0
downsample_chain.launches_bf16 = 0  # of them, on bf16 inputs


def upsample_chain(
    xu: torch.Tensor, cond: torch.Tensor, wconv, bconv, wfilm, bfilm, w5, b5,
    fold_k: int = 0, bout: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One Upsample body (kernel F): ``xu [B, C, >=T]``, ``cond [B, C, T]``
    (both fp32 or both bf16) -> ``[B, Co, T]`` in ``out_dtype``, or
    ``[B, 1, T]`` fp32 with ``fold_k=7``."""
    ws = dict(wconv=wconv, bconv=bconv, wfilm=wfilm, bfilm=bfilm, w5=w5, b5=b5)
    if fold_k:
        if bout is None:
            raise ValueError("fold_k needs the output conv's bias bout")
        ws["bout"] = bout
    if out_dtype not in DTYPES or (fold_k and out_dtype != torch.float32):
        raise ValueError(f"out_dtype {out_dtype} is not one this chain stores")
    if build.on_cpu(xu, cond, *ws.values()):
        return upsample_chain_plain(xu, cond, wconv, bconv, wfilm, bfilm, w5, b5, fold_k, bout,
                                    out_dtype)
    build.check_input("xu", xu, 3, DTYPES)
    build.check_input("cond", cond, 3, (xu.dtype,))
    _check_weights(**ws)
    B, C, T = cond.shape
    if xu.shape[:2] != (B, C) or xu.shape[2] < T:
        raise ValueError(f"xu {tuple(xu.shape)} does not cover cond {tuple(cond.shape)}")
    if fold_k not in (0, 7):
        raise ValueError(f"fold_k must be 0 or 7, got {fold_k}")
    co = 1 if fold_k else w5.shape[0]
    for name, shape in (("wconv", (4, C, 3 * C)), ("bconv", (4, C, 1)), ("wfilm", (4 * C, C)),
                        ("bfilm", (4 * C, 1)), ("w5", (fold_k or co, C)),
                        ("b5", (fold_k or co, 1))):
        _check_shape(name, ws[name], shape)
    if fold_k:
        _check_shape("bout", bout, (1, 1))
    R = R_UP + ((fold_k - 1) // 2 if fold_k else 0)
    out = torch.empty((B, co, T), device=xu.device, dtype=out_dtype)
    work = torch.empty((2, B, C, T + 2 * R), device=xu.device, dtype=torch.float32)
    bf16 = xu.dtype == torch.bfloat16
    build.launch("tvc_up_chain", xu, xu, cond, wconv, bconv, wfilm, bfilm, w5, b5,
                 bout if fold_k else b5, out, work, B, C, co, T, xu.shape[2], fold_k,
                 int(bf16), int(out_dtype == torch.bfloat16))
    upsample_chain.launches += 1
    upsample_chain.launches_bf16 += bf16
    return out


upsample_chain.launches = 0
upsample_chain.launches_bf16 = 0  # of them, on bf16 inputs
