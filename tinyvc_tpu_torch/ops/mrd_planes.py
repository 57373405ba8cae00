"""Phase-plane formulation of the MRD discriminator's conv stack
(counterpart of `tinyvc_tpu/ops/mrd_planes.py`, with the same names).

Each MRD resolution is a chain of six 2D convs over a spectrogram
``[B, 1, bins, W]``, strided 2 along the bin axis ``h``. In the
phase-plane-major layout the bin axis is split into ``S`` planes, plane
``p`` holding rows ``h = S*g + p``; a stride-2 conv reading
``x[2h + i - ph]`` from ``S_in = 2*S_out`` planes becomes, for output plane
``q`` and tap ``i``, a unit-step read of plane ``phi = t mod S_in`` at row
offset ``delta = t // S_in``, ``t = 2q + i - ph``. Plane counts halve layer
by layer while the rows per plane stay about constant, so every tap is a
``[cout, cin] @ [cin, rows*Wp]`` product over one contiguous window.

A feature map is stored ``[B, C, S, (G + 4) * Wp]``: each plane block holds
``G + 4`` rows of ``Wp = W + 2`` columns, flattened; rows 0-1 and the last
two are zero halos (the conv's zero padding in ``h``), columns 0 and
``W + 1`` the zero padding in ``w``. A tap (delta, j) is the flat slice
``[(2 + delta) * Wp + (j - 1), + G_out * Wp)``; reads across a row end land
on a zero pad column, and the outputs they make are zeroed by each plane's
validity mask.

This module is the static plan, the spectrogram packing and the plain
PyTorch chain (:func:`mrd_chain_xla`, JAX's name kept): the plain version
of kernel M (`kernels/mrd.py`); in fp32 its autograd equals the plain
versions of kernels N and O written out there. The chain is linear (the reference's dropped MRD
activation), the only mode the fused path supports.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    cin: int
    cout: int
    kh: int
    kw: int
    stride: int
    ph: int
    pw: int
    s_in: int
    s_out: int
    g_in: int
    g_out: int
    h_in: int
    h_out: int
    # taps[q][i] = (phi, delta) for output plane q, h-tap i
    taps: Tuple[Tuple[Tuple[int, int], ...], ...]
    # valid rows per output plane q
    valid_out: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MrdPlan:
    resolution: int
    T: int
    W: int  # STFT frames (centre framing: 1 + T // hop)
    Wp: int  # W + 2 (zero pad columns)
    bins: int
    s0: int  # initial plane count (2 ** (num_layers + 1))
    layers: Tuple[LayerPlan, ...]

    def buf_len(self, layer_idx: int) -> int:
        """Flat per-plane buffer length of layer ``layer_idx``'s input."""
        return (self.layers[layer_idx].g_in + 4) * self.Wp

    def flat_len(self, layer_idx: int) -> int:
        """Length of layer ``layer_idx``'s flat output ``s_out*(g_out+4)*Wp``."""
        lp = self.layers[layer_idx]
        return lp.s_out * (lp.g_out + 4) * self.Wp

    def valid_count(self, layer_idx: int) -> int:
        """Number of valid (h, w) positions in layer ``layer_idx``'s output
        (``h_out * W``, the dense feature map's size per [B, c])."""
        return self.layers[layer_idx].h_out * self.W

    def out_mask(self, layer_idx: int) -> np.ndarray:
        """0/1 mask over the output buffer ``[s_out, (g_out+4)*Wp]``."""
        lp = self.layers[layer_idx]
        m = np.zeros((lp.s_out, lp.g_out + 4, self.Wp), np.float32)
        for q in range(lp.s_out):
            m[q, 2 : 2 + lp.valid_out[q], 1 : 1 + self.W] = 1.0
        return m.reshape(lp.s_out, -1)


def make_plan(resolution: int, T: int, channels: int = 32, max_channels: int = 256,
              num_layers: int = 4) -> MrdPlan:
    n_fft = resolution * 4
    bins = n_fft // 2 + 1
    W = 1 + T // resolution
    s0 = 2 ** (num_layers + 1)

    specs: List[Tuple[int, int, int, int, int, int, int]] = []
    c = channels
    specs.append((1, c, 7, 3, 2, 3, 1))  # conv_0
    for _ in range(num_layers):
        nxt = min(c * 2, max_channels)
        specs.append((c, nxt, 5, 3, 2, 2, 1))
        c = nxt
    specs.append((c, 1, 3, 3, 1, 1, 1))  # post

    layers: List[LayerPlan] = []
    h = bins
    s = s0
    for cin, cout, kh, kw, stride, ph, pw in specs:
        s_in = s
        s_out = s // 2 if stride == 2 else s
        h_out = (h + 2 * ph - kh) // stride + 1
        g_in = -(-h // s_in)
        g_out = -(-h_out // s_out)
        # the slice bound (3 + g_out) * Wp <= (g_in + 4) * Wp
        assert g_out <= g_in + 1, (resolution, h, s_in, g_in, g_out)
        taps = []
        for q in range(s_out):
            row = []
            for i in range(kh):
                t = stride * q + i - ph
                phi, delta = t % s_in, t // s_in
                assert -1 <= delta <= 1, (resolution, stride, q, i, delta)
                row.append((phi, delta))
            taps.append(tuple(row))
        valid = tuple(max(0, -(-(h_out - q) // s_out)) if q < h_out else 0
                      for q in range(s_out))
        layers.append(LayerPlan(cin=cin, cout=cout, kh=kh, kw=kw, stride=stride, ph=ph, pw=pw,
                                s_in=s_in, s_out=s_out, g_in=g_in, g_out=g_out, h_in=h,
                                h_out=h_out, taps=tuple(taps), valid_out=valid))
        h, s = h_out, s_out
    return MrdPlan(resolution=resolution, T=T, W=W, Wp=W + 2, bins=bins, s0=s0,
                   layers=tuple(layers))


def pack_spec_planes(spec: torch.Tensor, plan: MrdPlan) -> torch.Tensor:
    """``spec [B, bins, W]`` -> plane-major ``[B, 1, S0, (G0+4)*Wp]``: row
    ``h = S0*g + p`` lands in plane ``p`` at row ``g`` (pads, a reshape and
    a transpose)."""
    B = spec.shape[0]
    S, G, W, Wp = plan.s0, plan.layers[0].g_in, plan.W, plan.Wp
    x = F.pad(spec, (0, 0, 0, S * G - plan.bins))
    x = x.reshape(B, G, S, W).transpose(1, 2)  # [B, S, G, W]
    x = F.pad(x, (1, 1, 2, 2))
    return x.reshape(B, 1, S, (G + 4) * Wp)


def unpack_planes(y: torch.Tensor, plan: MrdPlan, layer_idx: int) -> torch.Tensor:
    """Plane-major layer output -> dense ``[B, c, H, W]``."""
    lp = plan.layers[layer_idx]
    B, c = y.shape[0], lp.cout
    y = y.reshape(B, c, lp.s_out, lp.g_out + 4, plan.Wp)
    y = y[:, :, :, 2 : 2 + lp.g_out, 1 : 1 + plan.W]
    y = y.transpose(2, 3).reshape(B, c, lp.s_out * lp.g_out, plan.W)
    return y[:, :, : lp.h_out]


def _tap_slices(lp: LayerPlan, Wp: int):
    """``[q][i*kw + j] -> (phi, flat start)``; every slice is ``g_out * Wp``
    long."""
    out = []
    for q in range(lp.s_out):
        row = []
        for i in range(lp.kh):
            phi, delta = lp.taps[q][i]
            for j in range(lp.kw):
                row.append((phi, (2 + delta) * Wp + (j - 1)))
        out.append(row)
    return out


def _operand(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``t`` as a product operand: rounded to bf16 and kept in fp32 (the
    product of two such values is exact in fp32) under ``bf16``."""
    return t.to(torch.bfloat16).float() if bf16 else t.float()


def apply_layer_xla(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, layer_idx: int,
                    plan: MrdPlan, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One conv layer in the plane-major layout.

    x ``[B, cin, s_in, (g_in+4)*Wp]``, w ``[kh, kw, cin, cout]`` (HWIO), b
    ``[cout]`` -> ``[B, cout, s_out, (g_out+4)*Wp]`` in ``dtype``: the
    products take ``dtype`` operands with fp32 sums, then the fp32 bias and
    the mask (JAX's ``preferred_element_type=float32``).
    """
    lp = plan.layers[layer_idx]
    B = x.shape[0]
    Wp = plan.Wp
    L = lp.g_out * Wp
    bf16 = dtype == torch.bfloat16
    mask = torch.from_numpy(plan.out_mask(layer_idx)[:, 2 * Wp : 2 * Wp + L]).to(x.device)
    taps = _tap_slices(lp, Wp)
    wf = _operand(w.reshape(lp.kh * lp.kw, lp.cin, lp.cout), bf16)
    xo = _operand(x, bf16)
    planes = []
    for q in range(lp.s_out):
        acc = None
        for t_i, (phi, s0) in enumerate(taps[q]):
            term = torch.einsum("bcl,cf->bfl", xo[:, :, phi, s0 : s0 + L], wf[t_i])
            acc = term if acc is None else acc + term
        planes.append((acc + b.float()[None, :, None]) * mask[q])
    y = torch.stack(planes, dim=2)  # [B, cout, s_out, g_out*Wp]
    y = F.pad(y, (2 * Wp, 2 * Wp))
    return y.to(dtype)


def mrd_chain_xla(spec_pm: torch.Tensor, weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor], plan: MrdPlan,
                  dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """The whole plane-major chain; every layer's output (the last is the
    logits), each ``[B, cout, s_out, (g_out+4)*Wp]``."""
    outs = []
    x = spec_pm
    for li, (w, b) in enumerate(zip(weights, biases)):
        x = apply_layer_xla(x, w, b, li, plan, dtype=dtype)
        outs.append(x)
    return outs
