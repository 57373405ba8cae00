"""The JAX package's random keys, in numpy integer arithmetic.

`tinyvc_tpu` seeds its hashed noise (kernel B) with one int32 drawn from a
``jax.random`` key: ``jax.random.randint(key, (), 0, int32 max)``
(`tinyvc_tpu/models/decoder.py:427-429`), with ``key = PRNGKey(seed)``. Its
decoder training step draws the volume gain and the noise phases with
``jax.random.uniform`` (`tinyvc_tpu/train/decoder_train.py:243-245`,
`tinyvc_tpu/models/decoder.py:100-103`).
Chunked conversion draws its noise phases per global frame,
``uniform(fold_in(key, i), (bins,), -pi, pi)``
(`tinyvc_tpu/parallel/time_shard.py::_per_frame_angles`).
This module computes the same numbers without JAX, for the default
configuration of jax 0.9: ``jax_default_prng_impl = "threefry2x32"``,
``jax_threefry_partitionable = True`` and ``jax_enable_x64 = False``. It
follows `jax/_src/prng.py` (``threefry_seed``, ``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``) and
`jax/_src/random.py::_randint` and ``_uniform``, in ``uint32`` arithmetic that wraps as
XLA's does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of the counter pair
    ``(x0, x1)`` under ``key`` ``[2]`` uint32 (or ``[2, ...]``, one key a
    counter, broadcast against them); returns two uint32 arrays."""
    k0, k1 = np.asarray(key[0], _U32), np.asarray(key[1], _U32)
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as ``[2]`` uint32: without x64 the seed
    is cut to its low 32 bits, and the high word is 0."""
    return np.array([0, int(np.int64(seed)) & 0xFFFFFFFF], dtype=_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> ``[num, 2]`` uint32 (the
    partitionable split: counter ``i`` as the pair (0, i))."""
    hi, lo = threefry2x32(key, np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([hi, lo], axis=1)


def random_bits32(key: np.ndarray) -> np.uint32:
    """``jax.random.bits(key, (), uint32)``: one 32-bit draw, the XOR of
    the cipher's two words at counter (0, 0)."""
    hi, lo = threefry2x32(key, np.zeros(1, _U32), np.zeros(1, _U32))
    return (hi ^ lo)[0]


def random_bits(key: np.ndarray, shape, rows: Optional[slice] = None) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``: the cipher of the counters
    ``(0, i)``, ``i`` the flat index (a 64-bit iota split into two words),
    its two words XORed. ``rows``: only those rows of axis 0 of the draw
    (the same values, computing no other counter)."""
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2**32:
        raise ValueError(f"random_bits supports fewer than 2**32 values, got {n}")
    shape = tuple(shape)
    i = np.arange(n, dtype=_U32)
    if rows is not None:
        inner = n // shape[0]
        i = i[rows.start * inner:rows.stop * inner]
        shape = (rows.stop - rows.start,) + shape[1:]
    hi, lo = threefry2x32(key, np.zeros_like(i), i)
    return (hi ^ lo).reshape(shape)


def _bits_to_uniform(bits: np.ndarray, minval: float, maxval: float) -> np.ndarray:
    """uint32 draws -> ``jax.random.uniform``'s float32 values (`uniform`)."""
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    fma = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fma.astype(np.float32))


def uniform(key: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0,
            rows: Optional[slice] = None) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    random mantissa bits under the exponent of 1.0, minus 1, scaled and
    shifted, and floored at ``minval``. XLA fuses the scale and shift into
    one multiply-add (one rounding); here the product is exact in float64
    and the sum is rounded to float64, then to float32, which differs from
    one rounding only where the float64 sum lands on a float32 tie.
    ``rows``: only those rows of axis 0 (a data-parallel rank's rows of a
    draw over the global batch)."""
    return _bits_to_uniform(random_bits(key, shape, rows), minval, maxval)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for each of the integers ``data``
    -> ``[..., 2]`` uint32 keys: the cipher of the counter pair ``(0,
    uint32(data))``, ``data`` taken mod 2**32 as JAX's uint32 cast takes a
    negative int32 (the pair `split` uses for counter ``i``)."""
    data = (np.asarray(data, np.int64) & 0xFFFFFFFF).astype(_U32)
    hi, lo = threefry2x32(key, np.zeros_like(data), data)
    return np.stack([hi, lo], axis=-1)


def per_frame_angles(key: np.ndarray, frame_indices, bins: int) -> np.ndarray:
    """The per-global-frame noise phases of chunked conversion, ``[F,
    bins]`` float32 in [-pi, pi): row ``f`` is ``uniform(fold_in(key, i),
    (bins,), -pi, pi)`` for ``i = frame_indices[f]``
    (`tinyvc_tpu/parallel/time_shard.py::_per_frame_angles`). The reference
    for :func:`per_frame_angles_torch`."""
    keys = fold_in(key, frame_indices)  # [F, 2]
    j = np.arange(bins, dtype=_U32)[None]
    hi, lo = threefry2x32((keys[:, :1], keys[:, 1:]), np.zeros_like(j), j)
    return _bits_to_uniform(hi ^ lo, -np.pi, np.pi)


_M32 = 0xFFFFFFFF


def _threefry2x32_torch(k0, k1, x0, x1):
    """:func:`threefry2x32` on int64 tensors holding uint32 values (each sum
    masked to 32 bits; a shift of a 32-bit value stays under 2**63)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a, b = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = (((b << r) & _M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def per_frame_angles_torch(key: np.ndarray, frame_indices: torch.Tensor,
                           bins: int) -> torch.Tensor:
    """:func:`per_frame_angles` on ``frame_indices``' device, bit for bit:
    ``frame_indices`` int64 ``[F]`` (negative ones wrap mod 2**32) -> ``[F,
    bins]`` float32. A 60 s utterance's table is ~3.4 M draws, which the
    host's numpy cipher would take seconds for."""
    dev = frame_indices.device
    data = frame_indices.to(torch.int64) & _M32
    k0 = torch.full_like(data, int(key[0]))
    k1 = torch.full_like(data, int(key[1]))
    fk0, fk1 = _threefry2x32_torch(k0, k1, torch.zeros_like(data), data)
    j = torch.arange(bins, dtype=torch.int64, device=dev)[None]
    hi, lo = _threefry2x32_torch(fk0[:, None], fk1[:, None], torch.zeros_like(j), j)
    floats = ((((hi ^ lo) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)
    lo_, hi_ = np.float32(-np.pi), np.float32(np.pi)
    fma = floats.double() * float(hi_ - lo_) + float(lo_)
    return torch.clamp_min(fma.float(), float(lo_))


def randint_int32(key: np.ndarray, minval: int = 0, maxval: int = 2**31 - 1) -> int:
    """``jax.random.randint(key, (), minval, maxval, dtype=int32)`` for
    ``int32`` bounds with ``minval < maxval``: two 32-bit draws from a split
    key, folded into the span by the modulus scheme of ``_randint``."""
    if not -(2**31) <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"need int32 bounds with minval < maxval, got {minval}, {maxval}")
    k1, k2 = split(key)
    higher, lower = int(random_bits32(k1)), int(random_bits32(k2))
    span = maxval - minval  # < 2**32, as uint32
    mask = 0xFFFFFFFF
    multiplier = (2**16 % span) * (2**16 % span) & mask  # uint32 product wraps
    multiplier %= span
    offset = (((higher % span) * multiplier & mask) + lower % span) & mask
    offset %= span
    return int(np.int64(minval + offset).astype(np.int32))


def kernel_b_seed(seed: int) -> int:
    """The int32 that the JAX package's ``convert(key=PRNGKey(seed))`` hands
    its hashed-noise kernel: ``randint(PRNGKey(seed), (), 0, int32 max)``."""
    return randint_int32(prng_key(seed))
