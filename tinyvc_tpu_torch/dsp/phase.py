"""Wrapped exclusive prefix of per-frame phase increments (counterpart of
`tinyvc_tpu/dsp/phase.py`).

Only phase mod 1 matters for integer harmonics, and a flat fp32 cumsum loses
that precision as its total grows. Every accumulator here stays below ~1:
a wrapped sequential scan within groups of 64 frames, and the wrapped group
totals prefixed by recursion, as in the JAX package.
"""

from __future__ import annotations

import torch

GROUP = 64


def _wrapped_scan_prefix(x: torch.Tensor):
    """Sequential exclusive prefix over the last axis, wrapped mod 1 after
    every add. Returns (prefix [..., n], wrapped totals [...])."""
    carry = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    outs = []
    for t in range(x.shape[-1]):
        outs.append(carry)
        carry = carry + x[..., t]
        carry = carry - torch.floor(carry)
    return torch.stack(outs, dim=-1), carry


def wrapped_exclusive_prefix(x: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """Exclusive prefix sum over the last axis, accurate mod 1 for any
    length. ``x``: ``[..., F]`` increments already wrapped to [0, 1)."""
    n = x.shape[-1]
    if n <= group:
        return _wrapped_scan_prefix(x)[0]
    pad = (-n) % group
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    nb = (n + pad) // group
    inner, totals = _wrapped_scan_prefix(xp.reshape(*x.shape[:-1], nb, group))
    outer = wrapped_exclusive_prefix(totals, group)
    off = inner + outer[..., None]
    off = off - torch.floor(off)
    return off.reshape(*x.shape[:-1], nb * group)[..., :n]
