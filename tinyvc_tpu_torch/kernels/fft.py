"""The FFT inside kernels G and B (`csrc/fft.cuh`), in plain PyTorch.

A real transform of length ``n_fft = N`` runs as a complex FFT of
``M = N/2`` points: the frame is packed as ``z[n] = x[2n] + i x[2n+1]``, a
mixed-radix FFT transforms ``z``, and a split step turns ``Z`` into the
``M + 1`` bins of ``x``. ``M`` may have the factors 2, 3 and 5 only and
``N <= 2048``; :func:`fft_radices` gives the passes (for ``N = 1920``,
``M = 960``: radix 8, radix 8, radix 15, the last a 3 x 5 Good-Thomas DFT
without twiddles).

The forward transform (kernel G) is decimation in frequency: the passes run
in order on the natural-order frame, each butterfly of radix ``r`` and span
``S`` takes ``r`` values ``S`` apart, transforms them and multiplies output
``m`` by ``W_L^(j*m)`` (``L = r*S``, ``j`` the butterfly's offset in its
block), and bin ``k`` ends at :func:`bin_positions`'s mixed-radix
digit-reversed position. The inverse (kernel B) runs the same passes
backwards as decimation in time: the spectrum is written at those positions,
each butterfly first multiplies input ``m`` by the conjugate twiddle, then
takes the conjugate DFT, and the frame comes out in natural order.

Every twiddle is an entry of the table that the wrappers build in float64
and round to fp32 (``W^m = cos - i sin`` of ``2*pi*m/N``,
`spectrogram.py::_table_np`); the kernels hold the same entries in shared
memory. These functions mirror the kernels' decomposition step by step, for
the CPU tests; the main path does not call them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..dsp.stft import _frame, hann_window, overlap_add

MAX_NFFT = 2048


def fft_radices(m: int) -> tuple:
    """The passes of an ``m``-point complex FFT: radix 8 while it divides
    the power of two, then 4 or 2; then radix 15 (one 3 with one 5) while
    both divide, then 3s, then 5s. Raises unless ``m >= 2`` has no prime
    factor but 2, 3 and 5."""
    rest, count = m, {}
    for p in (2, 3, 5):
        count[p] = 0
        while rest % p == 0 and rest > 1:
            rest //= p
            count[p] += 1
    if m < 2 or rest != 1:
        raise ValueError(f"the FFT needs n_fft/2 = {m} >= 2 with prime factors 2, 3, 5 only")
    twos, threes, fives = count[2], count[3], count[5]
    radices = [8] * (twos // 3) + {0: [], 1: [2], 2: [4]}[twos % 3]
    fifteens = min(threes, fives)
    radices += [15] * fifteens + [3] * (threes - fifteens) + [5] * (fives - fifteens)
    return tuple(radices)


def check_n_fft(n_fft: int) -> None:
    """Raise unless kernels G and B take ``n_fft``: even, at most 2048,
    with ``n_fft/2`` a product of 2s, 3s and 5s."""
    if n_fft % 2 or n_fft > MAX_NFFT:
        raise ValueError(f"the FFT kernels need an even n_fft <= {MAX_NFFT}, got {n_fft}")
    fft_radices(n_fft // 2)


def _spans(radices, m):
    """(radix, span) of each pass: the span ``S`` of pass ``p`` is
    ``m / (r_0 ... r_p)``."""
    out, s = [], m
    for r in radices:
        s //= r
        out.append((r, s))
    return out


def bin_positions(m: int) -> np.ndarray:
    """Where bin ``k`` of the forward passes lands: digit ``p`` of ``k``
    (least significant first, radix ``r_p``) times the span of pass ``p``."""
    k = np.arange(m)
    pos = np.zeros(m, dtype=np.int64)
    for r, s in _spans(fft_radices(m), m):
        pos += (k % r) * s
        k = k // r
    return pos


@functools.lru_cache(maxsize=None)
def twiddle_table(n_fft: int) -> np.ndarray:
    """``W^m = exp(-2*pi*i*m/n_fft)``, computed in float64, rounded to fp32
    (complex64), ``m < n_fft``."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return (np.cos(ang).astype(np.float32) - 1j * np.sin(ang).astype(np.float32)).astype(
        np.complex64)


@functools.lru_cache(maxsize=None)
def _plan(n_fft: int):
    """Per pass (radix, span, twiddles ``[r, S]`` = ``W_L^(j*m)`` as table
    entries ``j*m*n_fft/L``) and the small DFT matrices, as complex64
    numpy arrays."""
    m = n_fft // 2
    tab = twiddle_table(n_fft)
    passes = []
    for r, s in _spans(fft_radices(m), m):
        jm = np.arange(r)[:, None] * np.arange(s)[None, :]
        passes.append((r, s, tab[jm * (n_fft // (r * s))]))
    dft = {r: tab[(np.arange(r)[:, None] * np.arange(r)[None, :] % r) * (n_fft // r)]
           for r in {2, 3, 4, 5, 8} if n_fft % r == 0}
    return passes, dft


def _small_dft(a: torch.Tensor, r: int, dft: dict) -> torch.Tensor:
    """DFT over dim -2 (``[..., r, S]``). Radix 15 is Good-Thomas: input
    ``(5*n1 + 3*n2) mod 15``, three-point DFTs over ``n1``, five-point DFTs
    over ``n2``, output ``(10*k1 + 6*k2) mod 15``; no twiddles."""
    if r != 15:
        return torch.einsum("qm,...qs->...ms", torch.from_numpy(dft[r]), a)
    n1, n2 = np.meshgrid(np.arange(3), np.arange(5), indexing="ij")
    t = a[..., torch.from_numpy((5 * n1 + 3 * n2) % 15).reshape(-1), :]
    t = t.reshape(*a.shape[:-2], 3, 5, a.shape[-1])
    t = torch.einsum("qk,...qns->...kns", torch.from_numpy(dft[3]), t)
    t = torch.einsum("nk,...qns->...qks", torch.from_numpy(dft[5]), t)
    out = torch.empty_like(a)
    out[..., torch.from_numpy((10 * n1 + 6 * n2) % 15).reshape(-1), :] = t.reshape(a.shape)
    return out


def fft_dif(z: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Kernel G's passes: natural-order ``z [..., M]`` (complex64) -> its
    DFT in :func:`bin_positions` order."""
    passes, dft = _plan(n_fft)
    m = n_fft // 2
    buf = z
    for r, s, tw in passes:
        a = buf.reshape(*z.shape[:-1], m // (r * s), r, s)
        buf = (_small_dft(a, r, dft) * torch.from_numpy(tw)).reshape(z.shape)
    return buf


def fft_dit_inverse(buf: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Kernel B's passes, :func:`fft_dif` run backwards and conjugated:
    ``buf [..., M]`` in :func:`bin_positions` order -> the unnormalised
    inverse DFT ``sum_k Z[k] W_M^(-n*k)`` in natural order."""
    passes, dft = _plan(n_fft)
    m = n_fft // 2
    for r, s, tw in reversed(passes):
        a = buf.reshape(*buf.shape[:-1], m // (r * s), r, s) * torch.from_numpy(tw).conj()
        buf = _small_dft(a.conj(), r, dft).conj().reshape(buf.shape)
    return buf


def rfft_staged(x: torch.Tensor) -> torch.Tensor:
    """Real ``[..., N]`` fp32 -> complex64 ``[..., N/2 + 1]``, as kernel G:
    pack, :func:`fft_dif`, split ``X[k] = E + W^k O``, ``X[M-k] =
    conj(E - W^k O)`` with ``E = (Z[k] + conj Z[M-k]) / 2`` and
    ``O = -i (Z[k] - conj Z[M-k]) / 2``."""
    n_fft = x.shape[-1]
    check_n_fft(n_fft)
    m = n_fft // 2
    xf = x.float()
    z = torch.complex(xf[..., 0::2], xf[..., 1::2])
    zb = fft_dif(z, n_fft)
    pos = bin_positions(m)
    k = np.arange(m // 2 + 1)
    a = zb[..., torch.from_numpy(pos[k])]
    b = zb[..., torch.from_numpy(pos[(m - k) % m])].conj()
    e = 0.5 * (a + b)
    o = -0.5j * (a - b)
    wo = torch.from_numpy(twiddle_table(n_fft)[k]) * o
    out = torch.empty(*x.shape[:-1], m + 1, dtype=torch.complex64)
    out[..., torch.from_numpy(k)] = e + wo
    out[..., torch.from_numpy(m - k)] = (e - wo).conj()  # k = m/2 writes the same value
    return out


def irfft_staged(spec: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Complex ``[..., N/2 + 1]`` -> real fp32 ``[..., N]``, as kernel B;
    like ``torch.fft.irfft`` it ignores the imaginary parts at DC and
    Nyquist. The split runs backwards: ``Z[k] = E + i O``, ``Z[M-k] =
    conj(E) + i conj(O)`` with ``E = (X[k] + conj X[M-k]) / 2`` and
    ``O = conj(W^k) (X[k] - conj X[M-k]) / 2``; then
    :func:`fft_dit_inverse`, scaled by ``1/M``, unpacked."""
    m = spec.shape[-1] - 1
    n_fft = 2 * m if n is None else n
    if n_fft != 2 * m:
        raise ValueError(f"irfft_staged takes N/2 + 1 bins: {m + 1} bins, n={n_fft}")
    check_n_fft(n_fft)
    s = spec.to(torch.complex64).clone()
    s[..., 0] = s[..., 0].real.to(torch.complex64)
    s[..., m] = s[..., m].real.to(torch.complex64)
    k = np.arange(m // 2 + 1)
    xk = s[..., torch.from_numpy(k)]
    xm = s[..., torch.from_numpy(m - k)].conj()
    e = 0.5 * (xk + xm)
    o = torch.from_numpy(twiddle_table(n_fft)[k]).conj() * (0.5 * (xk - xm))
    pos = torch.from_numpy(bin_positions(m))
    buf = torch.empty(*spec.shape[:-1], m, dtype=torch.complex64)
    hi = k[(k > 0) & (2 * k != m)]
    buf[..., pos[torch.from_numpy(m - hi)]] = (e.conj() + 1j * o.conj())[..., torch.from_numpy(hi)]
    buf[..., pos[torch.from_numpy(k)]] = e + 1j * o
    z = fft_dit_inverse(buf, n_fft) * np.float32(1.0 / m)
    return torch.stack([z.real, z.imag], dim=-1).reshape(*spec.shape[:-1], n_fft)


def spectrogram_staged(x: torch.Tensor, n_fft: int = 1920, hop: int = 480) -> torch.Tensor:
    """Kernel G's function through :func:`rfft_staged`: framed (reflect
    padding, frame 0 dropped), windowed, transformed, ``sqrt(re^2 + im^2)``."""
    y = rfft_staged(_frame(x.float(), n_fft, hop, drop_first=True) * hann_window(n_fft))
    return torch.sqrt(y.real * y.real + y.imag * y.imag)


def oscillate_noise_staged(mag: torch.Tensor, angle: torch.Tensor, frame_size: int = 480,
                           n_fft: int = 1920) -> torch.Tensor:
    """Kernel B's function through :func:`irfft_staged`: ``mag`` with
    phases ``angle``, one zero frame prepended, the inverse STFT."""
    spec = torch.polar(mag.float(), angle.float())
    spec = torch.nn.functional.pad(spec, (0, 0, 1, 0))
    return overlap_add(irfft_staged(spec), frame_size)
