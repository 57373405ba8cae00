"""Frozen copies of the two hashes that fix the program's noise.

- :func:`kernel_b_seed`: ``jax.random.randint(PRNGKey(seed), (), 0, 2**31 -
  1)`` by threefry2x32 (jax 0.9 defaults: partitionable threefry, no x64),
  the int32 that a conversion with ``seed`` hands its noise synthesis.
- :func:`noise_angles`: the murmur3 counter hash that turns that int32 into
  per-bin noise phases in [-pi, pi), bit for bit.

Both are the published algorithms (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011; MurmurHash3's finaliser), written here in
numpy and torch integer arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def _threefry2x32(key, x0, x1):
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = ((x[1] << _U32(r)) | (x[1] >> _U32(32 - r))) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _bits32(key) -> int:
    hi, lo = _threefry2x32(key, np.zeros(1, _U32), np.zeros(1, _U32))
    return int((hi ^ lo)[0])


def kernel_b_seed(seed: int) -> int:
    """The int32 noise seed of a conversion with ``seed``: the key
    ``(0, seed mod 2**32)`` split in two, one 32-bit draw from each, folded
    into ``[0, 2**31 - 1)`` by JAX's modulus scheme."""
    key = np.array([0, int(seed) & _M32], dtype=_U32)
    hi, lo = _threefry2x32(key, np.zeros(2, _U32), np.arange(2, dtype=_U32))
    higher = _bits32((hi[0], lo[0]))
    lower = _bits32((hi[1], lo[1]))
    span = 2**31 - 1
    multiplier = ((2**16 % span) * (2**16 % span) & _M32) % span
    return (((higher % span) * multiplier & _M32) + lower % span) % span


def noise_rows(num_frames: int) -> int:
    """The padded spectrum rows that the hash index counts per batch row:
    tile ``t`` is the largest multiple of 8 in 128..8 dividing F (else
    128), ``rows = t + 3`` rounded up to 8."""
    t = next((c for c in range(128, 7, -8) if num_frames % c == 0), 128)
    rows = t + 3 + (-(t + 3)) % 8
    return max(2 + num_frames, (-(-num_frames // t) - 1) * t + rows)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def noise_angles(batch: int, num_frames: int, bins: int, seed: int, device,
                 row0: int = 0) -> torch.Tensor:
    """Phases ``[B, F, bins]`` float32 in [-pi, pi) of the batch rows
    ``row0 .. row0 + B``: MurmurHash3's finaliser of the counter ``((b *
    rows + f + 2) * 1024 + k) ^ seed``, its top 23 bits as a fraction of a
    turn."""
    b = torch.arange(row0, row0 + batch, dtype=torch.int64, device=device)[:, None, None]
    p = torch.arange(num_frames, dtype=torch.int64, device=device)[None, :, None] + 2
    k = torch.arange(bins, dtype=torch.int64, device=device)[None, None, :]
    h = (((b * noise_rows(num_frames) + p) * 1024 + k) & _M32) ^ (int(seed) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    u = (h >> 9).to(torch.float32) * (2.0 ** -23)
    return u * float(np.float32(2.0 * np.pi)) - float(np.float32(np.pi))
