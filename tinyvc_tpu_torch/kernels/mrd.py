"""Kernels M, N and O: the fused MRD chain, its input gradient and its
weight gradient (`csrc/mrd_fwd.cu`, `csrc/mrd_dx.cu`, `csrc/mrd_dw.cu`).

- M, :func:`mrd_forward`, replaces `tinyvc_tpu/ops/pallas/mrd.py::
  _fwd_pallas` (``_fwd_kernel``): one MRD resolution's whole conv stack in
  the phase-plane layout of `ops/mrd_planes.py`.
- N, :func:`mrd_dx`, replaces the dx sweep of ``_mrd_bwd``
  (``_bwd_kernel_dx``): top-down, each layer's masked cotangent
  ``dy = mask(cot + dx from above)`` and the gradient of its input; at
  layer 0 that is dspec.
- O, :func:`mrd_dw`, replaces the dW/db sweep (``_bwd_kernel_dw``): every
  tap's weight gradient ``x_slice @ dy_q^T`` and the bias gradient, summed
  over the planes and the batch.

Every map is flat plane-major ``[B, c, s*(g+4)*Wp]`` with exact zeros off
the valid positions; weights come as the effective (weight-normalised) HWIO
``[kh, kw, cin, cout]`` fp32 kernels, biases ``[cout]`` fp32. The operand
dtype is the input's: fp32, or bf16 (the TPU's choice) with fp32 sums, bf16
maps, fp32 bias, masks and carried dx, and dspec in bf16 (`mrd.py:355`).

CPU tensors take the plain versions; CUDA tensors launch the kernels, or
raise. The plain version of M is `ops/mrd_planes.py::mrd_chain_xla`; those
of N and O are written out below as the TPU kernels compute them (their
fp32 results equal autograd through the plain chain,
`tests/test_torch_mrd.py`). Each wrapper counts its calls that launched
(``launches``, ``launches_bf16``); a call is one CUDA launch per layer for M,
at most two for N and three for O (bf16 O: one for both width-1 layers'
gathers, one a tensor-core layer, one for the partials' sum).

With bf16 operands M and N run their products on the tensor cores from
weights packed to bf16 ``[kh*3, pad32(cin), pad32(cout)]`` (:func:`_packed`)
and from a position-major copy of the operand, ``[B, positions,
pad32(channels)]``: M's launch of layer ``li`` packs layer ``li + 1``'s
weights and writes its output both ways; N's launch of layer ``li`` packs
layer ``li - 1``'s and forms the layer below's dy from its own dx in its
epilogue, both ways (the top layer's dy has a launch of its own, which
packs its weights): scratch the wrapper allocates, no launch of its own.
bf16 N is thus one launch a layer and one more, fp32 N two a layer. In
fp32 N carries dx down, computed only on the rows the layer below reads,
``[2, 2 + valid rows)`` of each plane; dspec on every position. M and N
hand their copies back (:func:`mrd_forward`'s ``copies``, :func:`mrd_dx`'s
``dyts``), and bf16 O reads its tensor-core layers' operands from them,
interior rows only (the copies' halo rows are never written): x of layer
``li`` is M's copy of layer ``li - 1``'s output. Its blocks split each such
layer's positions as :func:`dw_schedule` says and write partials that its
last launch adds in a fixed order; the width-1 layers (cin = 1, cout = 1)
read the plane-major maps.

:class:`MrdChain` (``mrd_chain``, JAX's name) is the differentiable chain:
forward M, backward N then O, with ``mrd.py::mrd_chain``'s signature.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from ..ops.mrd_planes import MrdPlan, _operand, _tap_slices, mrd_chain_xla
from . import build

DTYPES = (torch.float32, torch.bfloat16)
WGRAD_CHUNK = 1024  # positions of one block's weight-gradient partial sum, fp32 O
# bf16 O's tensor-core tiles (`csrc/mrd_dw.cu`): positions a chunk of the
# split schedule, output channels a block, and the blocks a layer's grid
# aims at, twice the H100 SXM's 132 SMs
DW_BK, DW_BN, DW_FILL = 128, 64, 2 * 132
DW_GATHER = 256  # positions a block of its width-1 layers' gathers


def _dtype(name: str) -> torch.dtype:
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"dtype_name must be 'float32' or 'bfloat16', got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _mask(plan: MrdPlan, li: int, device) -> torch.Tensor:
    """0/1 over layer ``li``'s flat output (`mrd.py::_mask_full`)."""
    return torch.from_numpy(plan.out_mask(li).reshape(-1)).to(device)


def _layer_args(plan: MrdPlan, li: int, B: int) -> Tuple[int, ...]:
    lp = plan.layers[li]
    return (B, lp.cin, lp.cout, lp.kh, lp.stride, lp.ph, lp.s_in, lp.s_out, lp.g_in, lp.g_out,
            plan.Wp, plan.W, lp.h_in, lp.h_out)


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def _packed(plan: MrdPlan, layers: Sequence[int], device) -> List[torch.Tensor]:
    """One bf16 scratch buffer, cut into each of ``layers``' packed weights
    ``[kh*3*pad32(cin)*pad32(cout)]`` (16-byte aligned); None elsewhere."""
    sizes = {li: plan.layers[li].kh * plan.layers[li].kw * _pad32(plan.layers[li].cin)
             * _pad32(plan.layers[li].cout) for li in layers}
    buf = torch.empty(sum(sizes.values()), device=device, dtype=torch.bfloat16)
    out, off = [None] * len(plan.layers), 0
    for li, n in sizes.items():
        out[li] = buf[off:off + n]
        off += n
    return out


def _in_len(plan: MrdPlan, li: int) -> int:
    return plan.layers[li].s_in * plan.buf_len(li)


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    build.check_input(name, t, len(shape), (dtype,))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_weights(ws, bs, plan: MrdPlan) -> None:
    if len(ws) != len(plan.layers) or len(bs) != len(plan.layers):
        raise ValueError(f"expected {len(plan.layers)} weights and biases")
    for li, (lp, w, b) in enumerate(zip(plan.layers, ws, bs)):
        _check(f"w{li}", w, (lp.kh, lp.kw, lp.cin, lp.cout), torch.float32)
        _check(f"b{li}", b, (lp.cout,), torch.float32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def mrd_forward_plain(spec: torch.Tensor, ws: Sequence[torch.Tensor],
                      bs: Sequence[torch.Tensor], plan: MrdPlan) -> List[torch.Tensor]:
    """Plain version of M: ``spec [B, 1, S0*(G0+4)*Wp]`` in the operand
    dtype -> every layer's flat output in that dtype."""
    B = spec.shape[0]
    x = spec.reshape(B, 1, plan.s0, -1)
    outs = mrd_chain_xla(x, ws, bs, plan, dtype=spec.dtype)
    return [o.reshape(B, o.shape[1], -1) for o in outs]


def mrd_dx_plain(cots: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                 plan: MrdPlan) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain version of N: the cotangents of every layer's flat output, in
    the operand dtype -> (dspec ``[B, 1, S0*(G0+4)*Wp]`` and the masked
    cotangents ``dy``, in that dtype)."""
    dys: List[torch.Tensor] = [None] * len(plan.layers)
    above = None
    for li in range(len(plan.layers) - 1, -1, -1):
        dys[li], above = mrd_dx_layer_plain(cots[li], above, ws[li], plan, li)
    return above.to(cots[0].dtype), dys


def mrd_dx_layer_plain(cot: torch.Tensor, above, w: torch.Tensor, plan: MrdPlan,
                       li: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the plain N: layer ``li``'s output cotangent ``cot`` (the
    operand dtype) and the fp32 dx carried from the layer above (None at the
    top) -> (``dy = where(valid, cot + above, 0)`` in the operand dtype, the
    fp32 gradient of the layer's input on every position). A select, as the
    kernel forms it: ``above`` off the valid positions is never read."""
    dt = cot.dtype
    lp, Wp = plan.layers[li], plan.Wp
    B = cot.shape[0]
    L, blk_in, blk_out = lp.g_out * Wp, (lp.g_in + 4) * Wp, (lp.g_out + 4) * Wp
    cur = cot.float()
    if above is not None:
        cur = cur + above
    dy = torch.where(_mask(plan, li, cur.device) != 0, cur, 0.0).to(dt)
    w = _operand(w.reshape(lp.kh * lp.kw, lp.cin, lp.cout), dt == torch.bfloat16)
    dyf = dy.float()
    dx = torch.zeros((B, lp.cin, lp.s_in, blk_in), device=dyf.device)
    for q, taps in enumerate(_tap_slices(lp, Wp)):
        dyq = dyf[:, :, q * blk_out + 2 * Wp: q * blk_out + 2 * Wp + L]
        for t_i, (phi, s0) in enumerate(taps):
            dx[:, :, phi, s0:s0 + L] += torch.einsum("cf,bfl->bcl", w[t_i], dyq)
    return dy, dx.reshape(B, lp.cin, -1)


def mrd_dw_plain(xs: Sequence[torch.Tensor], dys: Sequence[torch.Tensor],
                 plan: MrdPlan) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Plain version of O: each layer's flat input ``xs`` (the spectrogram,
    then every output but the last) and masked cotangent ``dys``, in the
    operand dtype -> (HWIO weight gradients, bias gradients), fp32."""
    B, Wp = xs[0].shape[0], plan.Wp
    dws, dbs = [], []
    for li, lp in enumerate(plan.layers):
        L, blk_out = lp.g_out * Wp, (lp.g_out + 4) * Wp
        x = xs[li].float().reshape(B, lp.cin, lp.s_in, -1)
        dy = dys[li].float()
        acc = torch.zeros((lp.kh * lp.kw, lp.cin, lp.cout), device=dy.device)
        for q, taps in enumerate(_tap_slices(lp, Wp)):
            dyq = dy[:, :, q * blk_out + 2 * Wp: q * blk_out + 2 * Wp + L]
            for t_i, (phi, s0) in enumerate(taps):
                acc[t_i] += torch.einsum("bcl,bfl->cf", x[:, :, phi, s0:s0 + L], dyq)
        dws.append(acc.reshape(lp.kh, lp.kw, lp.cin, lp.cout))
        dbs.append(dy.sum(dim=(0, 2)))
    return dws, dbs


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def mrd_forward(spec: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                plan: MrdPlan) -> Tuple[List[torch.Tensor], List]:
    """Kernel M: ``spec [B, 1, S0*(G0+4)*Wp]`` (fp32 or bf16, the operand
    dtype) -> (every layer's flat output ``[B, cout, s_out*(g_out+4)*Wp]`` in
    that dtype, the last the logits; ``copies``: under bf16, layer ``li``'s
    output position-major ``[B, s_out*(g_out+4)*Wp, pad32(cout)]`` where
    layer ``li + 1`` reads it on the tensor cores, halo rows unwritten, else
    None)."""
    if build.on_cpu(spec, *ws, *bs):
        return mrd_forward_plain(spec, ws, bs, plan), [None] * len(plan.layers)
    build.check_input("spec", spec, 3, DTYPES)
    B = spec.shape[0]
    _check("spec", spec, (B, 1, _in_len(plan, 0)), spec.dtype)
    _check_weights(ws, bs, plan)
    bf16 = spec.dtype == torch.bfloat16
    nl = len(plan.layers)
    mma = [bf16 and lp.cin > 1 and lp.cout > 1 for lp in plan.layers]
    if mma[0]:
        raise ValueError("layer 0 must read one channel: nothing packs its weights")
    wp = _packed(plan, [li for li in range(nl) if mma[li]], spec.device)
    outs, copies, x, xt = [], [], spec, None
    for li, lp in enumerate(plan.layers):
        out = torch.empty((B, lp.cout, plan.flat_len(li)), device=spec.device, dtype=spec.dtype)
        nxt = li + 1 < nl and mma[li + 1]
        wn, dims = (ws[li + 1], plan.layers[li + 1]) if nxt else (None, None)
        outt = (torch.empty((B, plan.flat_len(li), _pad32(lp.cout)), device=spec.device,
                            dtype=torch.bfloat16) if nxt else None)
        build.launch("tvc_mrd_fwd", spec, x, xt, ws[li], bs[li], out, outt, wp[li], wn,
                     wp[li + 1] if nxt else None, *((dims.kh, dims.cin, dims.cout) if nxt
                                                    else (0, 0, 0)),
                     *_layer_args(plan, li, B), int(bf16))
        outs.append(out)
        copies.append(outt)
        x, xt = out, outt
    mrd_forward.launches += 1
    mrd_forward.launches_bf16 += bf16
    return outs, copies


mrd_forward.launches = 0
mrd_forward.launches_bf16 = 0  # of them, on bf16 inputs


def mrd_dx(cots: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
           plan: MrdPlan) -> Tuple[torch.Tensor, List[torch.Tensor], List]:
    """Kernel N: the cotangents of every layer's flat output (fp32 or bf16,
    the operand dtype) -> (dspec ``[B, 1, S0*(G0+4)*Wp]``, the masked
    cotangents ``dy``, in that dtype; ``dyts``: under bf16, each ``dy``
    position-major ``[B, s_out*(g_out+4)*Wp, pad32(cout)]`` where the layer
    reads more than one channel (its halo rows unwritten below the top
    layer), else None)."""
    if build.on_cpu(*cots, *ws):
        return (*mrd_dx_plain(cots, ws, plan), [None] * len(plan.layers))
    dt = cots[0].dtype
    build.check_input("cot0", cots[0], 3, DTYPES)
    B = cots[0].shape[0]
    for li, (lp, c) in enumerate(zip(plan.layers, cots)):
        _check(f"cot{li}", c, (B, lp.cout, plan.flat_len(li)), dt)
        _check(f"w{li}", ws[li], (lp.kh, lp.kw, lp.cin, lp.cout), torch.float32)
    bf16 = dt == torch.bfloat16
    nl = len(plan.layers)
    dys: List[torch.Tensor] = [torch.empty_like(c) for c in cots]
    dyt: List = [None] * nl
    if not bf16:  # dy, then dx, a layer; the fp32 dx carried down
        above = None
        for li in range(nl - 1, -1, -1):
            lp = plan.layers[li]
            dx = torch.empty((B, lp.cin, _in_len(plan, li)), device=dys[li].device,
                             dtype=torch.float32)
            build.launch("tvc_mrd_dx", cots[li], cots[li], above, dys[li], None, dx, ws[li], None,
                         None, None, None, None, None, 0, 0, 0, *_layer_args(plan, li, B), 0, 0)
            above = dx
    else:  # the top layer's dy, then one launch a layer forming the next dy
        mma = [lp.cin > 1 for lp in plan.layers]
        if mma[0] or not all(mma[1:]):
            raise ValueError("only layer 0 may read one channel")
        wp = _packed(plan, [li for li in range(nl) if mma[li]], cots[0].device)
        dyt = [torch.empty((B, plan.flat_len(li), _pad32(lp.cout)), device=dys[li].device,
                           dtype=torch.bfloat16) if mma[li] else None
               for li, lp in enumerate(plan.layers)]
        for li in range(nl - 1, 0, -1):
            lb, below = plan.layers[li - 1], li - 1
            nxt = mma[below]
            build.launch("tvc_mrd_dx", cots[li], cots[li] if li == nl - 1 else None, None,
                         dys[li], dyt[li], None, ws[li], wp[li], cots[below], dys[below],
                         dyt[below], ws[below] if nxt else None, wp[below] if nxt else None,
                         *((lb.kh, lb.cin, lb.cout) if nxt else (0, 0, 0)),
                         *_layer_args(plan, li, B), 1, 0)
        above = torch.empty((B, 1, _in_len(plan, 0)), device=dys[0].device, dtype=dt)
        build.launch("tvc_mrd_dx", cots[0], None, None, dys[0], None, above, ws[0], None, None,
                     None, None, None, None, 0, 0, 0, *_layer_args(plan, 0, B), 1, 1)
    mrd_dx.launches += 1
    mrd_dx.launches_bf16 += bf16
    return above, dys, dyt


mrd_dx.launches = 0
mrd_dx.launches_bf16 = 0


def _dw_chunks(plan: MrdPlan, li: int, B: int) -> int:
    """fp32 O's partials of layer ``li``: fixed ``WGRAD_CHUNK`` slices of
    each (b, q)."""
    lp = plan.layers[li]
    return B * lp.s_out * (-(-lp.g_out * plan.Wp // WGRAD_CHUNK))


def _dw_mma(lp) -> bool:
    """bf16 O runs layer ``lp`` on the tensor cores (else a gather)."""
    return lp.cin > 1 and lp.cout > 1


def dw_plane_chunks(plan: MrdPlan, li: int, size: int = DW_BK) -> List[int]:
    """bf16 O's chunks of ``size`` positions in each output plane's valid
    rows, for one batch row (`csrc/mrd_dw.cu::make_walk`)."""
    return [-(-v * plan.Wp // size) for v in plan.layers[li].valid_out]


@functools.lru_cache(maxsize=64)
def dw_schedule(plan: MrdPlan, B: int) -> Tuple[int, ...]:
    """bf16 O's partials of each layer, from the shape alone: for a
    tensor-core layer the number of splits of its chunk list (batch row,
    plane, chunk; :func:`dw_split_chunks`), so that its grid (kh x cin
    tiles x cout tiles blocks a split) comes near ``DW_FILL`` blocks and
    not over (a third block on an SM outlasts the others), at most one
    split a chunk; for a width-1 layer one per ``DW_GATHER``
    positions of each plane's valid rows (a block of its gather)."""
    parts = []
    for li, lp in enumerate(plan.layers):
        if not _dw_mma(lp):
            parts.append(B * sum(dw_plane_chunks(plan, li, DW_GATHER)))
            continue
        bm = 32 if lp.cin <= 32 else 64
        tiles = lp.kh * -(-lp.cin // bm) * -(-lp.cout // DW_BN)
        chunks = B * sum(dw_plane_chunks(plan, li))
        parts.append(max(1, min(chunks, DW_FILL // tiles)))
    return tuple(parts)


def dw_split_chunks(plan: MrdPlan, li: int, B: int, split: int) -> List[Tuple[int, int, int]]:
    """The (b, q, first position) of each chunk that split ``split`` of
    tensor-core layer ``li`` sums, in its order: chunks ``[split * n //
    S, (split + 1) * n // S)`` of the layer's n chunks, batch row by batch
    row, plane by plane (the kernel's walk)."""
    per_q = dw_plane_chunks(plan, li)
    per_b, S = sum(per_q), dw_schedule(plan, B)[li]
    n = B * per_b
    out = []
    for c in range(split * n // S, (split + 1) * n // S):
        b, w = divmod(c, per_b)
        q = 0
        while w >= per_q[q]:
            w -= per_q[q]
            q += 1
        out.append((b, q, w * DW_BK))
    return out


def dw_workspace(plan: MrdPlan, B: int) -> int:
    """Floats of bf16 O's partials: each layer's ``dw_schedule`` partials
    of ``kh*3*cin*cout + cout`` (dW, then db)."""
    return sum(n * (lp.kh * lp.kw * lp.cin * lp.cout + lp.cout)
               for n, lp in zip(dw_schedule(plan, B), plan.layers))


def mrd_dw(xs: Sequence[torch.Tensor], dys: Sequence[torch.Tensor], plan: MrdPlan,
           xts: Sequence | None = None, dyts: Sequence | None = None
           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Kernel O: each layer's flat input and masked cotangent (fp32 or bf16,
    the operand dtype) -> (HWIO weight gradients, bias gradients), fp32.
    Under bf16 on CUDA, ``xts`` and ``dyts`` give each tensor-core layer's
    input and dy position-major (``xts[li]`` is :func:`mrd_forward`'s
    ``copies[li - 1]``, ``dyts`` :func:`mrd_dx`'s); only their interior rows
    are read. The plain version and fp32 ignore them."""
    if build.on_cpu(*xs, *dys):
        return mrd_dw_plain(xs, dys, plan)
    dt = xs[0].dtype
    build.check_input("x0", xs[0], 3, DTYPES)
    B = xs[0].shape[0]
    for li, lp in enumerate(plan.layers):
        _check(f"x{li}", xs[li], (B, lp.cin, _in_len(plan, li)), dt)
        _check(f"dy{li}", dys[li], (B, lp.cout, plan.flat_len(li)), dt)
    dev = xs[0].device
    dws = [torch.empty((lp.kh, lp.kw, lp.cin, lp.cout), device=dev) for lp in plan.layers]
    dbs = [torch.empty((lp.cout,), device=dev) for lp in plan.layers]
    if dt == torch.float32:
        ws_len = max(_dw_chunks(plan, li, B) * lp.kh * lp.kw * lp.cin * lp.cout
                     for li, lp in enumerate(plan.layers))
        work = torch.empty(ws_len, device=dev)
        for li in range(len(plan.layers)):
            build.launch("tvc_mrd_dw", xs[li], xs[li], dys[li], work, ws_len, dws[li], dbs[li],
                         *_layer_args(plan, li, B), WGRAD_CHUNK)
    else:
        ptrs, dims = [], []
        for li, (lp, parts) in enumerate(zip(plan.layers, dw_schedule(plan, B))):
            if _dw_mma(lp):
                if xts is None or dyts is None or xts[li] is None or dyts[li] is None:
                    raise ValueError(f"layer {li}: bf16 O reads the position-major copies "
                                     "of its input and dy (xts, dyts)")
                _check(f"xt{li}", xts[li], (B, _in_len(plan, li), _pad32(lp.cin)), dt)
                _check(f"dyt{li}", dyts[li], (B, plan.flat_len(li), _pad32(lp.cout)), dt)
                ptrs += [None, xts[li].data_ptr(), None, dyts[li].data_ptr()]
            else:
                ptrs += [xs[li].data_ptr(), None, dys[li].data_ptr(), None]
            ptrs += [dws[li].data_ptr(), dbs[li].data_ptr()]
            dims += [*_layer_args(plan, li, B), parts]
        ws_len = dw_workspace(plan, B)
        work = torch.empty(ws_len, device=dev)
        build.launch("tvc_mrd_dw_bf16", xs[0], (ctypes.c_void_p * len(ptrs))(*ptrs),
                     (ctypes.c_int * len(dims))(*dims), len(plan.layers), work, ws_len)
    mrd_dw.launches += 1
    mrd_dw.launches_bf16 += dt == torch.bfloat16
    return dws, dbs


mrd_dw.launches = 0
mrd_dw.launches_bf16 = 0


# ---------------------------------------------------------------------------
# the differentiable chain
# ---------------------------------------------------------------------------


class MrdChain(torch.autograd.Function):
    """``spec_pm [B, 1, S0, (G0+4)*Wp]`` (fp32) and the effective weights
    and biases -> every layer's flat output in the operand dtype. Forward M
    on the spectrogram cast to the operand dtype, keeping its position-major
    copies for O; backward N then O, the cotangents cast to the operand
    dtype first (`mrd.py:337-339`) and dspec upcast after (`:373`)."""

    @staticmethod
    def forward(ctx, spec_pm, plan, dtype_name, *wb):
        nl = len(plan.layers)
        ws, bs = [w.detach() for w in wb[:nl]], [b.detach() for b in wb[nl:]]
        B = spec_pm.shape[0]
        spec = spec_pm.detach().reshape(B, 1, -1).to(_dtype(dtype_name)).contiguous()
        outs, copies = mrd_forward(spec, ws, bs, plan)
        ctx.save_for_backward(spec, *ws, *outs, *copies[:-1])
        ctx.plan, ctx.shape, ctx.spec_dtype = plan, spec_pm.shape, spec_pm.dtype
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        plan = ctx.plan
        nl = len(plan.layers)
        spec, *rest = ctx.saved_tensors
        ws, outs, copies = rest[:nl], rest[nl:2 * nl], rest[2 * nl:]
        cots = [torch.zeros_like(o) if c is None else c.to(o.dtype).contiguous()
                for c, o in zip(cots, outs)]
        dspec, dys, dyts = mrd_dx(cots, ws, plan)
        dws, dbs = mrd_dw([spec, *outs[:-1]], dys, plan, [None, *copies], dyts)
        return (dspec.to(ctx.spec_dtype).reshape(ctx.shape), None, None, *dws, *dbs)


def mrd_chain(spec_pm: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
              plan: MrdPlan, dtype_name: str = "bfloat16") -> List[torch.Tensor]:
    """The fused MRD chain (`tinyvc_tpu/ops/pallas/mrd.py::mrd_chain`):
    every layer's output as flat plane-major ``[B, cout, s_out*(g_out+4)*Wp]``
    in the operand dtype, the last the logits; use ``plan.valid_count(i)``
    for the losses' divisors."""
    return list(MrdChain.apply(spec_pm, plan, dtype_name, *ws, *bs))
