"""The work each layer of a conversion request needs, counted from the
request's shapes: operations and bytes, whatever implements them. A frozen
copy of the per-kernel counts and the bound of the port's `chip_smoke.py`
(``_bound``, ``_sum_bounds`` and the counts beside each ``_bound`` call),
with the published peaks of one NVIDIA H100 SXM.

A layer's least time is the sum over its calls of each call's bound: the
larger of its bytes over the memory rate and its operations over the peak of
their type. Bytes count each input read once and each output written once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
BF16_FLOPS = 989e12  # dense bf16 tensor cores
PEAKS = {"float32": FP32_FLOPS, "bfloat16": BF16_FLOPS}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Call:
    """One kernel-sized piece of work: bytes moved, operations at ``peak``,
    and operations that stay fp32 beside them."""

    nbytes: float
    flops: float
    peak: float = FP32_FLOPS
    fp32_flops: float = 0.0

    def bound_s(self) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S,
                   self.flops / self.peak + self.fp32_flops / FP32_FLOPS)

    def peak_s(self) -> float:
        """The operations' time at their peaks alone (the ``mfu`` sum)."""
        return self.flops / self.peak + self.fp32_flops / FP32_FLOPS


def _convnext_stack(R: int, cin: int, C: int, cout: int, layers: int, isz: int, peak: float,
                    k: int = 7) -> List[Call]:
    """Input 1x1, ConvNeXt layers (depthwise k, 1x1 to 2C, 1x1 back) and the
    output 1x1 over ``R`` frames."""
    calls = [Call(isz * R * (cin + C), 2.0 * R * cin * C, peak)]
    for _ in range(layers):
        calls.append(Call(isz * R * 2 * C, 2.0 * R * C * k, peak))
        calls.append(Call(isz * R * 3 * C, 4.0 * R * C * C, peak))
        calls.append(Call(isz * R * 3 * C, 4.0 * R * C * C, peak))
    calls.append(Call(isz * R * (C + cout), 2.0 * R * C * cout, peak))
    return calls


def spectrogram(B: int, L: int, n_fft: int, hop: int) -> List[Call]:
    """Per frame the window, a real FFT (2.5 n log2 n) and the magnitude."""
    frames, bins = B * (L // hop), n_fft // 2 + 1
    return [Call(4 * (B * L + frames * bins),
                 frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 4 * bins))]


def encoder(B: int, F: int, enc: Mapping, bins: int) -> List[Call]:
    R = B * F
    return (_convnext_stack(R, bins, enc["ssl_channels"], enc["ssl_dim"],
                            len(enc["ssl_dilations"]), 4, FP32_FLOPS)
            + _convnext_stack(R, bins, enc["pitch_channels"], enc["num_pitch_classes"],
                              enc["pitch_num_layers"], 4, FP32_FLOPS))


def knn(B: int, T: int, N: int, C: int) -> List[Call]:
    """The ``[R, C] x [C, N]`` similarity product in fp32; bytes: source and
    dictionary in, matched frames out."""
    R = B * T
    return [Call(4.0 * (2 * R * C + N * C), 2.0 * R * N * C)]


def energy(B: int, L: int, frame: int) -> List[Call]:
    """The max-pool and kernel C's linear upsample back to the rate."""
    P = L // frame
    return [Call(4 * (B * L + B * P), 0.0), Call(4 * B * P * (1 + frame), 5.0 * B * P * frame)]


def source(B: int, F: int, dec: Mapping, hop: int, n_fft: int) -> List[Call]:
    """SourceNet (its trunk in the decoder's dtype, the heads fp32) and the DSP
    source: kernel A (~12 fp32 operations an output) and kernel B (an
    inverse real FFT a frame, the polar product, window, overlap-add and the
    envelope divide)."""
    dt = dec["compute_dtype"]
    isz, peak = ITEMSIZE[dt], PEAKS[dt]
    R, C, H1 = B * F, dec["source_channels"], dec["num_harmonics"] + 1
    bins, L = n_fft // 2 + 1, F * hop
    calls = [Call(isz * R * (dec["content_channels"] + C), 2.0 * R * dec["content_channels"] * C,
                  peak),
             Call(isz * R * 2 * C, 4.0 * R * C, peak)]
    calls += _convnext_stack(R, C, C, C, dec["source_num_layers"], isz, peak,
                             dec["source_kernel_size"])[1:-1]
    calls += [Call(4 * R * (C + H1), 2.0 * R * C * H1), Call(4 * R * (C + bins), 2.0 * R * C * bins)]
    calls.append(Call(4 * (B * F + R * H1 + B * H1 * L), 12.0 * B * H1 * L))
    calls.append(Call(4 * (R * bins + B * L),
                      R * (2.5 * n_fft * math.log2(n_fft) + 2 * bins + 2 * n_fft + hop)))
    return calls


def unet(B: int, F: int, dec: Mapping, hop: int) -> List[Call]:
    """The fused U-Net at the request's shapes: the frame-rate 1x1s, the stem
    over the packed source, each decimation (D) and down chain (E), each
    interpolation (C) and up chain (F), the last with the k=7 output conv
    folded in (fp32 in either profile)."""
    dt = dec["compute_dtype"]
    isz, peak = ITEMSIZE[dt], PEAKS[dt]
    chans, facs = list(dec["filter_channels"]), list(dec["filter_factors"])
    L, R = F * hop, B * F
    n_src = dec["num_harmonics"] + 2
    pack = n_src + 1 + (-(n_src + 1)) % 8
    cc = dec["content_channels"]
    calls = [Call(4 * R * cc + isz * R * chans[0], 2.0 * R * cc * chans[0], peak),
             Call(4 * R + isz * R * chans[0], 2.0 * R * chans[0], peak)]
    cs = chans[-1]
    calls.append(Call(isz * (B * pack * L + B * cs * L), 2.0 * B * L * cs * 3 * (n_src + 1), peak))
    T = L
    down_out = list(reversed(chans[1:]))[1:] + [chans[0]]
    for cin, co, f in zip(reversed(chans[1:]), down_out, reversed(facs[1:])):
        n = B * cin * T
        calls.append(Call(isz * (n + n // f), 0.0 if f % 2 else 3.0 * n // f))
        T //= f
        calls.append(Call(isz * B * T * (cin + co), 2.0 * B * T * (6 * cin * cin + 4 * cin * co),
                          peak))
    Tx = F
    up_out = chans[1:] + [chans[-1]]
    for i, (c, co, f) in enumerate(zip(chans, up_out, facs)):
        n = B * c * Tx
        calls.append(Call(isz * n * (1 + f), 5.0 * n * f))
        Tx *= f
        fold = i == len(chans) - 1
        k5 = 7 if fold else co
        out_flops = 2.0 * B * Tx * k5 * c
        calls.append(Call(isz * B * Tx * 2 * c + (4 if fold else isz) * B * Tx * (1 if fold else co),
                          B * Tx * 32.0 * c * c + (0.0 if fold else out_flops), peak,
                          fp32_flops=out_flops if fold else 0.0))
    return calls


def request_layers(B: int, L: int, N: int, cfg: Mapping) -> Dict[str, List[Call]]:
    """Every layer's calls for one request of ``B`` rows padded to ``L``
    samples against an ``N``-row dictionary."""
    a, enc, dec = cfg["audio"], cfg["encoder"], cfg["decoder"]
    hop, n_fft = a["hop_size"], a["n_fft"]
    F = L // hop
    return dict(spectrogram=spectrogram(B, L, n_fft, hop),
                encoder=encoder(B, F, enc, n_fft // 2 + 1),
                energy=energy(B, L, a["energy_frame_size"]),
                retrieval=knn(B, F, N, enc["ssl_dim"]),
                source=source(B, F, dec, hop, n_fft),
                unet=unet(B, F, dec, hop))


def least_s(calls: List[Call]) -> float:
    return sum(c.bound_s() for c in calls)


def peak_s(calls: List[Call]) -> float:
    return sum(c.peak_s() for c in calls)
