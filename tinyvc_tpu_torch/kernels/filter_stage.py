"""Kernels E, F, K and L: the fused U-Net's conv chains and their
gradients (`csrc/filter_stage.cu`, `csrc/filter_stage_bwd.cu`).

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
is 1 CUDA launch for the stem, 3 for a down chain and 5 for an up chain
(CUDA-core tiles in both precisions, `conv_tile`; the chains size their
workspace, `_launch_sized`), and for their gradients 4, 15 and 27 in fp32
(CUDA-core tiles), 4, 12 and 19 with bf16 operands (tensor-core tiles over
position-major bf16 copies, `csrc/unet_tiles.cuh`).

The training step's gradients (the JAX package's custom_vjp entries
``up_chain_vjp``, ``down_chain_vjp``, ``stem_conv_vjp``):

- K, :func:`upsample_chain_grad`, replaces
  `tinyvc_tpu/ops/pallas/filter_stage.py::fused_upsample_chain_t_bwd`
  (``_up_bwd_kernel``, ``_spill_add``), with and without the folded output
  conv (then it also returns ``gbout``, and the gradients of the folded
  ``w5c = w_out @ w5`` and ``b5c = w_out @ b5``, which autograd carries back
  to ``w5``, ``b5`` and the output conv).
- L, :func:`downsample_chain_grad` and :func:`conv3_grad`, replace
  ``_run_down_bwd`` (``fused_downsample_chain_t_bwd``, ``fused_conv3_t_bwd``).

Each is the exact vjp of its forward: the gradient of the edge-replicated
pad folds onto the first and last input sample. Their plain versions are
autograd through the plain forwards above, with the bf16 rounding of the
JAX package's backward kernels: a product's operands are rounded in the
forward with a straight-through gradient, its cotangent is rounded before
both of its transposed products (``_conv_cf_T``, ``_taps_cf`` cast it),
the bias and every elementwise step see the fp32 cotangent, and the folded
output conv, fp32 in the forward, rounds its operands in the backward as
the TPU does (``gw5``/``g_r2`` in ``_up_bwd_kernel``). In fp32 they are
plain autograd. :class:`UpChain`, :class:`DownChain` and :class:`Stem`
(``up_chain_vjp``, ``down_chain_vjp``, ``stem_conv_vjp``, the JAX
package's names) are the differentiable chains, forward F or E, backward K
or L.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

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


class _LReLUAt(torch.autograd.Function):
    """``lrelu(h)`` whose derivative takes the branch of ``m``'s sign, ``m``
    the forward's value of ``h``: a recomputed ``h`` within a rounding of 0
    may lie on the other side of it."""

    @staticmethod
    def forward(ctx, h, m):
        ctx.save_for_backward(m)
        return _lrelu(h)

    @staticmethod
    def backward(ctx, g):
        (m,) = ctx.saved_tensors
        return torch.where(m > 0, g, g * 0.1), None


def _act(h: torch.Tensor, pre: Optional[torch.Tensor], record: bool, j: int,
         lo: int) -> torch.Tensor:
    """``lrelu(h)`` for the chain's ``j``-th inner pre-activation ``h``
    (columns from ``lo`` of ``pre[j]``): with ``record`` ``h`` is written
    there; else, given ``pre``, the derivative takes its branches."""
    if pre is None:
        return _lrelu(h)
    m = pre[j][..., lo:lo + h.shape[-1]]
    if record:
        m.copy_(h.detach())
        return _lrelu(h)
    return _LReLUAt.apply(h, m)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _operand(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``t`` as a product operand: rounded to bf16 (and kept in fp32, where
    a product of two such values is exact) under bf16, else as it is. Under
    autograd the rounding passes the gradient straight through."""
    if not bf16:
        return t
    if t.requires_grad and torch.is_grad_enabled():
        return t + (_round_bf16(t) - t).detach()
    return _round_bf16(t)


class _RoundCotangent(torch.autograd.Function):
    """Identity whose backward rounds the cotangent to bf16: placed after a
    bf16 product, so that both of its transposed products take a bf16
    cotangent, as the TPU's backward kernels cast it."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round_bf16(g)


def _product(y: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A bf16 product's result, its cotangent rounded to bf16 under
    autograd."""
    if bf16 and y.requires_grad and torch.is_grad_enabled():
        return _RoundCotangent.apply(y)
    return y


class _FoldProduct(torch.autograd.Function):
    """``w5c @ h`` of the folded output conv: fp32 in the forward (the TPU
    runs it at HIGHEST); under bf16 its backward rounds ``w5c``, ``h`` and
    the cotangent to bf16, as ``_up_bwd_kernel`` does."""

    @staticmethod
    def forward(ctx, w, h, bf16):
        ctx.save_for_backward(w, h)
        ctx.bf16 = bf16
        return torch.matmul(w, h)

    @staticmethod
    def backward(ctx, g):
        w, h = ctx.saved_tensors
        if ctx.bf16:
            w, h, g = _round_bf16(w), _round_bf16(h), _round_bf16(g)
        gw = torch.matmul(g, h.transpose(1, 2)).sum(0)
        return gw, torch.matmul(w.T, g), None


def _conv_valid(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int,
                bf16: bool = False) -> torch.Tensor:
    """Unpadded dilated conv of ``[B, Cin, T]`` with packed ``w [Co, K*Cin]``,
    on bf16-rounded operands under ``bf16``; fp32 sums."""
    co, cin = w.shape[0], x.shape[1]
    weight = _operand(w, bf16).reshape(co, -1, cin).transpose(1, 2)
    return _product(F.conv1d(_operand(x, bf16), weight, dilation=d), bf16) + b.reshape(-1, 1)


def _edge_pad(x: torch.Tensor, T: int, r: int) -> torch.Tensor:
    return F.pad(x[..., :T], (r, r), mode="replicate")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _conv3(x: torch.Tensor, w, b, bf16: bool) -> torch.Tensor:
    return _conv_valid(_edge_pad(x, x.shape[-1], 1), w, b, 1, bf16)


def conv3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stem: ``[B, Cin, T]`` -> ``[B, Co, T]`` (in ``x``'s dtype), one
    k=3 conv with ``w [Co, 3*Cin]``."""
    return _conv3(x.float(), w, b, x.dtype == torch.bfloat16).to(x.dtype)


def _down_chain(z: torch.Tensor, wres, bres, w1, b1, w2, b2, w3, b3, T: int,
                bf16: bool, pre: Optional[torch.Tensor] = None,
                record: bool = False) -> torch.Tensor:
    x = _edge_pad(z, T, R_DOWN)
    res = _product(torch.matmul(_operand(wres, bf16),
                                _operand(x[..., R_DOWN:R_DOWN + T], bf16)), bf16) + bres
    h = _conv_valid(_lrelu(x), w1, b1, 1, bf16)  # columns from 1
    h = _conv_valid(_act(h, pre, record, 0, 1), w2, b2, 2, bf16)  # from 3
    h = _conv_valid(_act(h, pre, record, 1, 3), w3, b3, 4, bf16)  # from 7
    return h + res


def chain_pre(z: torch.Tensor, T: int, fold_k: Optional[int] = None) -> torch.Tensor:
    """The fp32 buffer of a chain's inner pre-activations, uninitialised on
    ``z``'s device: ``[2, B, C, T + 14]`` (h1, h2) for a down chain, or with
    ``fold_k`` ``[3, B, C, T + 2R]`` for an up chain (the first conv's, the
    first FiLM's and the third conv's). The forward writes them
    (``pre=``), and the backward takes their leaky-ReLU branches."""
    B, C = z.shape[:2]
    if fold_k is None:
        return torch.empty((2, B, C, T + 2 * R_DOWN), device=z.device)
    return torch.empty((3, B, C, T + 2 * _up_reach(fold_k)), device=z.device)


def _up_reach(fold_k: int) -> int:
    """An up chain's reach on each side: R_UP, and the folded conv's half."""
    return R_UP + ((fold_k - 1) // 2 if fold_k else 0)


def downsample_chain_plain(
    z: torch.Tensor, wres, bres, w1, b1, w2, b2, w3, b3, out_len: Optional[int] = None,
    pre: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One Downsample body: ``[B, Cin, >=T]`` -> ``[B, Co, T]`` (in ``z``'s
    dtype): ``1x1(z) + conv_d4(lrelu(conv_d2(lrelu(conv_d1(lrelu(z))))))``;
    the inner pre-activations written to ``pre`` (`chain_pre`) if given."""
    T = z.shape[-1] if out_len is None else out_len
    return _down_chain(z.float(), wres, bres, w1, b1, w2, b2, w3, b3, T,
                       z.dtype == torch.bfloat16, pre, True).to(z.dtype)


def upsample_chain_plain(
    xu: torch.Tensor, cond: torch.Tensor, wconv, bconv, wfilm, bfilm, w5, b5,
    fold_k: int = 0, bout: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32, pre: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One Upsample body: ``xu [B, C, >=T]``, ``cond [B, C, T]`` ->
    ``[B, Co, T]``, or ``[B, 1, T]`` with ``fold_k`` (then ``w5 [k, C]``,
    ``b5 [k, 1]`` are the folded output-conv weights and ``bout [1, 1]`` its
    bias, and the product is fp32 also under bf16); the inner
    pre-activations written to ``pre`` (`chain_pre`) if given."""
    y = _up_chain(xu.float(), cond.float(), wconv, bconv, wfilm, bfilm, w5, b5, fold_k, bout,
                  xu.dtype == torch.bfloat16, pre, True)
    return y if fold_k else y.to(out_dtype)


def _up_chain(xu: torch.Tensor, cond: torch.Tensor, wconv, bconv, wfilm, bfilm, w5, b5,
              fold_k: int, bout: Optional[torch.Tensor], bf16: bool,
              pre: Optional[torch.Tensor] = None, record: bool = False) -> torch.Tensor:
    B, C, T = cond.shape
    R = _up_reach(fold_k)
    x = _edge_pad(xu, T, R)
    films = _product(torch.matmul(_operand(wfilm, bf16), _operand(_edge_pad(cond, T, R), bf16)),
                     bf16) + bfilm

    def film(h, off, j, res):
        n = h.shape[-1]
        return (h * films[:, 2 * j * C:(2 * j + 1) * C, off:off + n]
                + films[:, (2 * j + 1) * C:(2 * j + 2) * C, off:off + n] + res[..., :n])

    h = _conv_valid(_lrelu(x), wconv[0], bconv[0], 1, bf16)  # columns from 1
    h = _conv_valid(_act(h, pre, record, 0, 1), wconv[1], bconv[1], 3, bf16)  # from 4
    h = film(h, 4, 0, x[..., 4:])
    res = h
    h = _conv_valid(_act(h, pre, record, 1, 4), wconv[2], bconv[2], 9, bf16)  # from 13
    h = _conv_valid(_act(h, pre, record, 2, 13), wconv[3], bconv[3], 27, bf16)  # from 40
    h = film(h, R_UP, 1, res[..., R_UP - 4:])
    if not fold_k:
        # columns [40, 40 + T): exactly [0, T)
        return _product(torch.matmul(_operand(w5, bf16), _operand(h, bf16)), bf16) + b5
    p = _FoldProduct.apply(w5, h, bf16) + b5
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


def _launch_sized(launch, device) -> None:
    """Launch an entry that sizes its own workspace through ``launch(ws,
    ws_bytes)``: asked first with a null workspace, it writes the bytes it
    needs to ``ws_bytes`` and launches nothing; then it runs on a byte
    workspace of that size."""
    need = ctypes.c_longlong(0)
    launch(None, ctypes.byref(need))
    launch(torch.empty(need.value, dtype=torch.uint8, device=device), ctypes.byref(need))


# The forward chains' tile (`csrc/filter_stage.cu::conv_rn`), mirrored for
# the tests: 6 warps a block, each TILE_ROWS // 6 output channels x 32 RN
# positions, the reduction in chunks of CHUNK_CHANNELS input channels
# (every tap of a channel in order).
TILE_WARPS = 6
TILE_ROWS = 24
CHUNK_CHANNELS = 8
H100_SMS = 132


def conv_tile(co: int, length: int, B: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(rows, positions) of a forward conv's blocks for ``co`` output
    channels over ``length`` positions of ``B`` batch rows: 24 rows; 128
    positions (RN = 4 a lane), or 64 where 128 leaves the grid with fewer
    than two blocks an SM."""
    blocks = B * -(-length // 128) * -(-co // TILE_ROWS)
    return TILE_ROWS, 64 if blocks < 2 * sms else 128


def conv_chunks(cin: int, taps: int) -> List[List[Tuple[int, int]]]:
    """The (input channel, tap) pairs of each chunk of a conv's reduction,
    in the order every output accumulates them: channel by channel, each
    channel's taps in order."""
    return [[(i, k) for i in range(i0, min(i0 + CHUNK_CHANNELS, cin)) for k in range(taps)]
            for i0 in range(0, cin, CHUNK_CHANNELS)]


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


def _check_pre(pre: Optional[torch.Tensor], shape) -> None:
    if pre is not None:
        build.check_input("pre", pre, 4)
        _check_shape("pre", pre, shape)


def downsample_chain(
    z: torch.Tensor, wres, bres, w1, b1, w2, b2, w3, b3, out_len: Optional[int] = None,
    pre: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One Downsample body (kernel E): ``[B, Cin, >=T]`` -> ``[B, Co, T]``,
    fp32 or bf16 in and out; the inner pre-activations written to ``pre``
    (`chain_pre`) if given."""
    ws = dict(wres=wres, bres=bres, w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
    if build.on_cpu(z, *ws.values(), *(() if pre is None else (pre,))):
        return downsample_chain_plain(z, wres, bres, w1, b1, w2, b2, w3, b3, out_len, pre)
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
    _check_pre(pre, (2, B, cin, T + 2 * R_DOWN))
    out = torch.empty((B, co, T), device=z.device, dtype=z.dtype)
    bf16 = z.dtype == torch.bfloat16
    _launch_sized(lambda *work: build.launch("tvc_down_chain", z, z, *ws.values(), out, pre,
                                             *work, B, cin, co, T, Tz, int(bf16)), z.device)
    downsample_chain.launches += 1
    downsample_chain.launches_bf16 += bf16
    return out


downsample_chain.launches = 0
downsample_chain.launches_bf16 = 0  # of them, on bf16 inputs


def upsample_chain(
    xu: torch.Tensor, cond: torch.Tensor, wconv, bconv, wfilm, bfilm, w5, b5,
    fold_k: int = 0, bout: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32, pre: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One Upsample body (kernel F): ``xu [B, C, >=T]``, ``cond [B, C, T]``
    (both fp32 or both bf16) -> ``[B, Co, T]`` in ``out_dtype``, or
    ``[B, 1, T]`` fp32 with ``fold_k=7``; the inner pre-activations written
    to ``pre`` (`chain_pre`) if given."""
    ws = dict(wconv=wconv, bconv=bconv, wfilm=wfilm, bfilm=bfilm, w5=w5, b5=b5)
    if fold_k:
        if bout is None:
            raise ValueError("fold_k needs the output conv's bias bout")
        ws["bout"] = bout
    if out_dtype not in DTYPES or (fold_k and out_dtype != torch.float32):
        raise ValueError(f"out_dtype {out_dtype} is not one this chain stores")
    if build.on_cpu(xu, cond, *ws.values(), *(() if pre is None else (pre,))):
        return upsample_chain_plain(xu, cond, wconv, bconv, wfilm, bfilm, w5, b5, fold_k, bout,
                                    out_dtype, pre)
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
    _check_pre(pre, (3, B, C, T + 2 * _up_reach(fold_k)))
    out = torch.empty((B, co, T), device=xu.device, dtype=out_dtype)
    bf16 = xu.dtype == torch.bfloat16
    _launch_sized(lambda *work: build.launch(
        "tvc_up_chain", xu, xu, cond, wconv, bconv, wfilm, bfilm, w5, b5, bout if fold_k else b5,
        out, pre, *work, B, C, co, T, xu.shape[2], fold_k, int(bf16),
        int(out_dtype == torch.bfloat16)), xu.device)
    upsample_chain.launches += 1
    upsample_chain.launches_bf16 += bf16
    return out


upsample_chain.launches = 0
upsample_chain.launches_bf16 = 0  # of them, on bf16 inputs


# ---------------------------------------------------------------------------
# gradients (kernels K and L) and the differentiable chains
# ---------------------------------------------------------------------------


def _vjp(fn, inputs, gy: torch.Tensor):
    """The vjp of ``fn(*inputs)`` for the cotangent ``gy``: each input as an
    fp32 leaf (a bf16 input keeps its values), the gradients fp32."""
    leaves = [t.detach().float().requires_grad_() for t in inputs]
    with torch.enable_grad():
        y = fn(*leaves)
        grads = torch.autograd.grad(y, leaves, gy.float(), allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))


def conv3_grad_plain(x: torch.Tensor, w, b, gy: torch.Tensor):
    """Plain PyTorch version of L in stem mode: (gx, gw, gb), fp32, for
    the stem's output cotangent ``gy [B, Co, T]``."""
    bf16 = x.dtype == torch.bfloat16
    return _vjp(lambda x_, w_, b_: _conv3(x_, w_, b_, bf16), (x, w, b), gy)


def downsample_chain_grad_plain(z: torch.Tensor, wres, bres, w1, b1, w2, b2, w3, b3,
                                gy: torch.Tensor, pre: Optional[torch.Tensor] = None):
    """Plain PyTorch version of L: (gz, gwres, gbres, gw1, gb1, gw2, gb2, gw3,
    gb3), fp32, for the chain's output cotangent ``gy [B, Co, T]``; ``z``
    may be longer than ``T`` (its tail gets no gradient). With ``pre``, the
    forward's inner pre-activations (`chain_pre`), the leaky ReLUs take
    their branches."""
    bf16 = z.dtype == torch.bfloat16
    T = gy.shape[-1]
    return _vjp(lambda *a: _down_chain(*a, T, bf16, pre),
                (z, wres, bres, w1, b1, w2, b2, w3, b3), gy)


def upsample_chain_grad_plain(xu: torch.Tensor, cond: torch.Tensor, wconv, bconv, wfilm, bfilm,
                              w5, b5, gy: torch.Tensor, fold_k: int = 0,
                              bout: Optional[torch.Tensor] = None,
                              pre: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K: (gxu, gcond, gwconv, gbconv, gwfilm,
    gbfilm, gw5, gb5, gbout), fp32, for the chain's output cotangent ``gy``
    (``gbout`` is zero without ``fold_k``). With ``pre``, the forward's
    inner pre-activations (`chain_pre`), the leaky ReLUs take their
    branches."""
    bf16 = xu.dtype == torch.bfloat16
    if not fold_k:
        bout = torch.zeros((1, 1), device=gy.device)
    return _vjp(lambda x_, c_, *ws: _up_chain(x_, c_, *ws[:6], fold_k, ws[6], bf16, pre),
                (xu, cond, wconv, bconv, wfilm, bfilm, w5, b5, bout), gy)


WGRAD_CHUNK = 1024  # columns of one block's weight-gradient partial sum (fp32)

# The bf16 route (`csrc/unet_tiles.cuh`): its weight-gradient products'
# split schedule. The C entries size their own workspace (`_launch_bf16`).
TC_CHUNK = 128  # positions a stage of a weight-gradient block
TC_FILL = 264  # blocks a weight-gradient product aims at: two an SM of the H100


class WgradProduct(NamedTuple):
    """One bf16 weight-gradient product: ``gw [co, taps*cin]`` summed over
    positions ``[lo, hi)`` of each batch row (``co``: the rows its tiles
    cover, the FiLM rows' four groups each padded to 8)."""

    co: int
    cin: int
    taps: int
    lo: int
    hi: int


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _tc_mt(rows: int) -> int:
    """m16 tiles of a bf16 block's rows (`unet_tiles.cuh::tc_mt`): 2, 3 or
    4, the fewest padded rows, then the most rows a block."""
    return min((4, 3, 2), key=lambda mt: (-(-rows // (16 * mt)) * 16 * mt, -mt))


def up_grad_products(C: int, co: int, T: int, fold_k: int = 0) -> Tuple[WgradProduct, ...]:
    """bf16 K's weight gradients in launch order: the four convs from the
    last (over each cotangent's range), the FiLM rows, the output 1x1 or
    the folded k=7 conv (over the cotangent's ``[R, R+T)``)."""
    R = R_UP + ((fold_k - 1) // 2 if fold_k else 0)
    E = T + 2 * R
    conv = [WgradProduct(C, C, 3, lo, E - lo) for lo in (40, 13, 4, 1)]
    return (*conv, WgradProduct(4 * _pad8(C), C, 1, 4, E - 4),
            WgradProduct(co, C, fold_k or 1, R, R + T))


def down_grad_products(cin: int, co: int, T: int) -> Tuple[WgradProduct, ...]:
    """bf16 L's weight gradients of a down chain: gw3, gw2, gw1, gwres."""
    R, E = R_DOWN, T + 2 * R_DOWN
    return (WgradProduct(co, cin, 3, R, R + T), WgradProduct(cin, cin, 3, 3, E - 3),
            WgradProduct(cin, cin, 3, 1, E - 1), WgradProduct(co, cin, 1, R, R + T))


def conv3_grad_products(cin: int, co: int, T: int) -> Tuple[WgradProduct, ...]:
    """bf16 L's weight gradient of the stem."""
    return (WgradProduct(co, cin, 3, 1, 1 + T),)


def wgrad_splits(B: int, p: WgradProduct) -> int:
    """The partials of a bf16 weight-gradient product, from the shape alone:
    its blocks (``unet_tiles.cuh::tc_wgrad``: rows of 16 ``_tc_mt`` by 10
    or 6 units of one tap and 8 channels) times the splits come near
    ``TC_FILL`` and not over, at most one split a chunk. The launcher
    checks only that the count is within [1, chunks]: a tile shape changed
    there and not here costs fill, not correctness."""
    mt = _tc_mt(p.co)
    units = p.taps * _pad8(p.cin) // 8
    tiles = -(-p.co // (16 * mt)) * -(-units // (10 if mt == 2 else 6))
    chunks = B * -(-(p.hi - p.lo) // TC_CHUNK)
    return max(1, min(chunks, TC_FILL // tiles))


def wgrad_split_chunks(B: int, p: WgradProduct, split: int) -> List[Tuple[int, int, int]]:
    """(b, first, end) of each chunk of positions that split ``split`` of
    product ``p`` sums, in order: chunks ``[split n / S, (split + 1) n /
    S)`` of its n, batch row by batch row (the kernel's walk)."""
    per_b = -(-(p.hi - p.lo) // TC_CHUNK)
    n, S = B * per_b, wgrad_splits(B, p)
    out = []
    for c in range(split * n // S, (split + 1) * n // S):
        b, k = divmod(c, per_b)
        first = p.lo + k * TC_CHUNK
        out.append((b, first, min(first + TC_CHUNK, p.hi)))
    return out


def _launch_bf16(launch, device, B: int, products) -> None:
    """Launch a bf16 entry of K or L through ``launch(ws, ws_bytes,
    splits)``, with the splits of ``products``, on the workspace it sizes
    (`_launch_sized`)."""
    splits = (ctypes.c_int * len(products))(*(wgrad_splits(B, p) for p in products))
    _launch_sized(lambda ws, need: launch(ws, need, splits), device)


def _tapsT(w: torch.Tensor, k: int = 3) -> torch.Tensor:
    """``[Co, k*Cin]`` tap-major -> the transposed conv's ``[Cin, k*Co]``
    with the taps reversed (`filter_stage.py::upsample_bwd_weights`)."""
    co = w.shape[0]
    return w.reshape(co, k, -1).flip(1).permute(2, 1, 0).reshape(-1, k * co).contiguous()


def _partial_floats(B: int, E: int, cols: int) -> int:
    return B * (-(-E // WGRAD_CHUNK)) * cols


def conv3_grad(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gy: torch.Tensor):
    """Gradient of :func:`conv3` (kernel L, stem mode): (gx, gw, gb) fp32
    for ``gy [B, Co, T]`` fp32."""
    if build.on_cpu(x, w, b, gy):
        return conv3_grad_plain(x, w, b, gy)
    build.check_input("x", x, 3, DTYPES)
    build.check_input("gy", gy, 3)
    _check_weights(w=w, b=b)
    B, cin, T = x.shape
    co = w.shape[0]
    _check_shape("w", w, (co, 3 * cin))
    _check_shape("gy", gy, (B, co, T))
    gx = torch.empty((B, cin, T), device=x.device)
    gw = torch.empty_like(w)
    gb = torch.empty((co, 1), device=x.device)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        _launch_bf16(lambda *ws: build.launch("tvc_conv3_grad_bf16", x, x, w, gy, gx, gw, gb,
                                              *ws, B, cin, co, T, T),
                     x.device, B, conv3_grad_products(cin, co, T))
    else:
        E = T + 2
        ws = torch.empty(B * cin * E + _partial_floats(B, E, co * 3 * cin + co), device=x.device)
        build.launch("tvc_conv3_grad", x, x, _tapsT(w), gy, gx, gw, gb, ws, ws.numel(),
                     B, cin, co, T, T, WGRAD_CHUNK)
    conv3_grad.launches += 1
    conv3_grad.launches_bf16 += bf16
    return gx, gw, gb


conv3_grad.launches = 0
conv3_grad.launches_bf16 = 0


def downsample_chain_grad(z: torch.Tensor, wres, bres, w1, b1, w2, b2, w3, b3,
                          gy: torch.Tensor, pre: Optional[torch.Tensor] = None):
    """Gradient of :func:`downsample_chain` (kernel L): (gz, gwres, gbres,
    gw1, gb1, gw2, gb2, gw3, gb3) fp32 for ``gy [B, Co, T]`` fp32. With
    ``pre``, the forward's inner pre-activations (`chain_pre`), the leaky
    ReLUs take their branches; without, those of the recomputed ones."""
    ws_ = dict(wres=wres, bres=bres, w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
    if build.on_cpu(z, gy, *ws_.values(), *(() if pre is None else (pre,))):
        return downsample_chain_grad_plain(z, wres, bres, w1, b1, w2, b2, w3, b3, gy, pre)
    build.check_input("z", z, 3, DTYPES)
    build.check_input("gy", gy, 3)
    _check_weights(**ws_)
    B, cin, Tz = z.shape
    co, T = gy.shape[1], gy.shape[2]
    if gy.shape[0] != B or not 0 < T <= Tz:
        raise ValueError(f"gy {tuple(gy.shape)} does not match z {tuple(z.shape)}")
    for name, shape in (("wres", (co, cin)), ("bres", (co, 1)), ("w1", (cin, 3 * cin)),
                        ("b1", (cin, 1)), ("w2", (cin, 3 * cin)), ("b2", (cin, 1)),
                        ("w3", (co, 3 * cin)), ("b3", (co, 1))):
        _check_shape(name, ws_[name], shape)
    _check_pre(pre, (2, B, cin, T + 2 * R_DOWN))
    out = [torch.empty((B, cin, Tz), device=z.device)] + [torch.empty_like(t)
                                                          for t in ws_.values()]
    bf16 = z.dtype == torch.bfloat16
    if bf16:
        _launch_bf16(lambda *ws: build.launch("tvc_down_chain_grad_bf16", z, z, w1, b1, w2, b2,
                                              w3, wres, gy, pre, *out, *ws, B, cin, co, T, Tz),
                     z.device, B, down_grad_products(cin, co, T))
    else:
        E = T + 2 * R_DOWN
        cols = max(co * 3 * cin + co, cin * 3 * cin + cin)
        ws = torch.empty(6 * B * cin * E + _partial_floats(B, E, cols), device=z.device)
        build.launch("tvc_down_chain_grad", z, z, w1, b1, w2, b2, _tapsT(w1), _tapsT(w2),
                     _tapsT(w3), wres.T.contiguous(), gy, pre, *out, ws, ws.numel(),
                     B, cin, co, T, Tz, WGRAD_CHUNK)
    downsample_chain_grad.launches += 1
    downsample_chain_grad.launches_bf16 += bf16
    return tuple(out)


downsample_chain_grad.launches = 0
downsample_chain_grad.launches_bf16 = 0


def upsample_chain_grad(xu: torch.Tensor, cond: torch.Tensor, wconv, bconv, wfilm, bfilm, w5,
                        b5, gy: torch.Tensor, fold_k: int = 0,
                        bout: Optional[torch.Tensor] = None,
                        pre: Optional[torch.Tensor] = None):
    """Gradient of :func:`upsample_chain` (kernel K): (gxu, gcond, gwconv,
    gbconv, gwfilm, gbfilm, gw5, gb5, gbout) fp32 for ``gy [B, Co, T]``
    fp32 (``[B, 1, T]`` with ``fold_k=7``; ``gbout`` is zero without it).
    With ``pre``, the forward's inner pre-activations (`chain_pre`), the
    leaky ReLUs take their branches; without, those of the recomputed
    ones."""
    ws_ = dict(wconv=wconv, bconv=bconv, wfilm=wfilm, bfilm=bfilm, w5=w5, b5=b5)
    if build.on_cpu(xu, cond, gy, *ws_.values(), *(() if pre is None else (pre,))):
        return upsample_chain_grad_plain(xu, cond, wconv, bconv, wfilm, bfilm, w5, b5, gy,
                                         fold_k, bout, pre)
    build.check_input("xu", xu, 3, DTYPES)
    build.check_input("cond", cond, 3, (xu.dtype,))
    build.check_input("gy", gy, 3)
    _check_weights(**ws_)
    B, C, T = cond.shape
    if xu.shape[:2] != (B, C) or xu.shape[2] < T:
        raise ValueError(f"xu {tuple(xu.shape)} does not cover cond {tuple(cond.shape)}")
    if fold_k not in (0, 7):
        raise ValueError(f"fold_k must be 0 or 7, got {fold_k}")
    co = 1 if fold_k else w5.shape[0]
    for name, shape in (("wconv", (4, C, 3 * C)), ("bconv", (4, C, 1)), ("wfilm", (4 * C, C)),
                        ("bfilm", (4 * C, 1)), ("w5", (fold_k or co, C)),
                        ("b5", (fold_k or co, 1))):
        _check_shape(name, ws_[name], shape)
    _check_shape("gy", gy, (B, co, T))
    R = _up_reach(fold_k)
    _check_pre(pre, (3, B, C, T + 2 * R))
    gx = torch.empty(xu.shape, device=xu.device)
    gc = torch.empty((B, C, T), device=xu.device)
    gw = [torch.empty_like(t) for t in (wconv, bconv, wfilm, bfilm, w5)]
    gb5 = torch.empty((1 if fold_k else co, 1), device=xu.device)
    bf16 = xu.dtype == torch.bfloat16
    if bf16:
        _launch_bf16(lambda *ws: build.launch("tvc_up_chain_grad_bf16", xu, xu, cond, wconv,
                                              bconv, wfilm, bfilm, w5, gy, pre, gx, gc, *gw, gb5,
                                              *ws, B, C, co, T, xu.shape[2], fold_k),
                     xu.device, B, up_grad_products(C, co, T, fold_k))
    else:
        E = T + 2 * R
        cols = max(4 * C * C + 4 * C, co * C + co, 7 * C + 1)
        ws = torch.empty(22 * B * C * E + _partial_floats(B, E, cols), device=xu.device)
        wconvT = torch.stack([_tapsT(wconv[j]) for j in range(4)])
        # the output 1x1 transposed, or the folded k=7 conv as one over the
        # 1-row cotangent: tap k of row i is w5c[6 - k, i]
        w5T = w5.flip(0).T.contiguous() if fold_k else w5.T.contiguous()
        build.launch("tvc_up_chain_grad", xu, xu, cond, wconv, bconv, wfilm, bfilm, wconvT,
                     wfilm.T.contiguous(), w5T, gy, pre, gx, gc, *gw, gb5, ws, ws.numel(),
                     B, C, co, T, xu.shape[2], fold_k, WGRAD_CHUNK)
    upsample_chain_grad.launches += 1
    upsample_chain_grad.launches_bf16 += bf16
    if fold_k:  # every folded tap's bias and the output bias sum the whole cotangent
        return (gx, gc, *gw, gb5.expand(fold_k, 1).contiguous(), gb5.reshape(1, 1))
    return (gx, gc, *gw, gb5, torch.zeros((1, 1), device=xu.device))


upsample_chain_grad.launches = 0
upsample_chain_grad.launches_bf16 = 0


def _dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


class Stem(torch.autograd.Function):
    """The differentiable stem: ``x`` cast to the operands' dtype, forward
    :func:`conv3` (kernel E), backward :func:`conv3_grad` (kernel L); the
    output in the operands' dtype, the input's gradient in ``x``'s."""

    @staticmethod
    def forward(ctx, x, w, b, bf16):
        xk = x.detach().to(_dtype(bf16)).contiguous()
        ctx.save_for_backward(xk, w, b)
        ctx.x_dtype = x.dtype
        return conv3(xk, w.detach(), b.detach())

    @staticmethod
    def backward(ctx, g):
        xk, w, b = ctx.saved_tensors
        gx, gw, gb = conv3_grad(xk, w, b, g.float().contiguous())
        return gx.to(ctx.x_dtype), gw, gb, None


class DownChain(torch.autograd.Function):
    """The differentiable Downsample body: forward :func:`downsample_chain`
    (kernel E) on ``z`` cast to the operands' dtype, backward
    :func:`downsample_chain_grad` (kernel L) on the leaky-ReLU branches of
    the forward's pre-activations."""

    @staticmethod
    def forward(ctx, z, wres, bres, w1, b1, w2, b2, w3, b3, bf16):
        zk = z.detach().to(_dtype(bf16)).contiguous()
        ws = (wres, bres, w1, b1, w2, b2, w3, b3)
        pre = chain_pre(zk, zk.shape[-1])
        out = downsample_chain(zk, *(w.detach() for w in ws), pre=pre)
        ctx.save_for_backward(zk, pre, *ws)
        ctx.z_dtype = z.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        zk, pre, *ws = ctx.saved_tensors
        gz, *gws = downsample_chain_grad(zk, *ws, g.float().contiguous(), pre)
        return (gz.to(ctx.z_dtype), *gws, None)


class UpChain(torch.autograd.Function):
    """The differentiable Upsample body: forward :func:`upsample_chain`
    (kernel F) on ``xu`` and ``cond`` cast to the operands' dtype, fp32 out;
    backward :func:`upsample_chain_grad` (kernel K) on the leaky-ReLU
    branches of the forward's pre-activations. With ``fold_k``, ``w5`` and
    ``b5`` are the folded output conv's and ``bout`` its bias."""

    @staticmethod
    def forward(ctx, xu, cond, wconv, bconv, wfilm, bfilm, w5, b5, bout, fold_k, bf16):
        dt = _dtype(bf16)
        xk = xu.detach().to(dt).contiguous()
        ck = cond.detach().to(dt).contiguous()
        ws = (wconv, bconv, wfilm, bfilm, w5, b5)
        pre = chain_pre(ck, ck.shape[-1], fold_k)
        out = upsample_chain(xk, ck, *(w.detach() for w in ws), fold_k=fold_k,
                             bout=None if bout is None else bout.detach(), pre=pre)
        ctx.save_for_backward(xk, ck, pre, *ws, *(() if bout is None else (bout,)))
        ctx.dtypes, ctx.fold_k = (xu.dtype, cond.dtype), fold_k
        return out

    @staticmethod
    def backward(ctx, g):
        xk, ck, pre, *ws = ctx.saved_tensors
        bout = ws[6] if ctx.fold_k else None
        gx, gc, *gws, gbout = upsample_chain_grad(xk, ck, *ws[:6], g.float().contiguous(),
                                                  ctx.fold_k, bout, pre)
        return (gx.to(ctx.dtypes[0]), gc.to(ctx.dtypes[1]), *gws,
                gbout if ctx.fold_k else None, None, None)


# The JAX package's names for the differentiable chains
stem_conv_vjp = Stem.apply
down_chain_vjp = DownChain.apply
up_chain_vjp = UpChain.apply
