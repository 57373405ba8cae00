"""The one traffic generator: a traffic file's parameters and a seed ->
the requests of a closed loop and the target speaker's audio.

A request is ``batch`` distinct utterances of one length. The lengths are a
fixed log-uniform grid of ``lengths_per_cycle`` values between
``seconds_min`` and ``seconds_max``; each cycle of requests takes every
length once, so every seed converts the same audio per cycle and only the
order and the sound differ. The order is a golden-ratio stride through the
sorted lengths from a starting point drawn from the seed for each cycle, so
that any run of consecutive requests, such as the part of a cycle that a
window ends in, mixes short and long ones as the whole cycle does. The
utterances of the first cycle are made in set-up and repeat in later cycles
(the program keeps nothing between requests); each request has its own
conversion seed and a pitch shift from the file's list.

The sound is speech-like, not noise (which would make every kNN similarity
alike): voiced stretches of harmonics under three moving formants with an
f0 gliding between ``f0_min`` and ``f0_max``, unvoiced stretches of bright
noise, and near-silence. Control tracks (10 ms steps) come from a numpy
generator seeded by the seed; the waveforms are rendered on the device in a
few large calls, with the noise from a ``torch.Generator`` on that device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

CONTROL_HOP = 240  # samples a control step: 10 ms at 24 kHz
HARMONICS = 40
SEED_SPACE = 2**63


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    length: int  # samples of each utterance, unpadded
    wave: np.ndarray  # [batch, length] float32
    pitch_shift: float
    seed: int  # the conversion's seed (VoiceConverter.convert's ``seed``)


def cycle_lengths(traffic: Mapping, sample_rate: int) -> List[int]:
    """The cycle's lengths in samples, shortest first: the midpoints of
    ``lengths_per_cycle`` equal steps of log length."""
    n = traffic["lengths_per_cycle"]
    lo, hi = math.log(traffic["seconds_min"]), math.log(traffic["seconds_max"])
    return [int(round(math.exp(lo + (i + 0.5) / n * (hi - lo)) * sample_rate)) for i in range(n)]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % SEED_SPACE, stream])


def cycle_order(seed: int, cycle: int, n: int) -> List[int]:
    """Cycle ``cycle``'s length indices: ``start + j * stride (mod n)``,
    the stride the integer nearest ``n / phi`` that is coprime to ``n``."""
    stride = min((k for k in range(1, n + 1) if math.gcd(k, n) == 1),
                 key=lambda k: abs(k - n / ((1 + 5 ** 0.5) / 2)))
    start = int(_rng(seed, 2 + cycle).integers(n))
    return [(start + j * stride) % n for j in range(n)]


def _segments(rng: np.random.Generator, steps: int, sp: Mapping) -> dict:
    """Per control step: voicing (0 silent, 1 voiced, 2 unvoiced), f0, gain
    and three formant frequencies."""
    kind = np.empty(steps, np.int64)
    f0 = np.empty(steps)
    gain = np.empty(steps)
    formants = np.empty((steps, 3))
    base = math.exp(rng.uniform(math.log(sp["f0_min"] * 1.3), math.log(sp["f0_max"] / 1.6)))
    t = 0
    while t < steps:
        k = rng.choice(3, p=sp["voicing_shares"])
        n = min(steps - t, int(rng.integers(*sp["segment_steps"][k])))
        kind[t:t + n] = k
        start = base * 2.0 ** rng.normal(0.0, 0.3)
        end = start * 2.0 ** rng.normal(0.0, 0.25)
        f0[t:t + n] = np.clip(np.geomspace(start, end, n), sp["f0_min"], sp["f0_max"])
        gain[t:t + n] = rng.uniform(*sp["gains"][k])
        for j, (lo, hi) in enumerate(sp["formants"]):
            formants[t:t + n, j] = np.linspace(rng.uniform(lo, hi), rng.uniform(lo, hi), n)
        t += n
    return dict(kind=kind, f0=f0, gain=gain, formants=formants)


def _smooth(x: np.ndarray, width: int = 5) -> np.ndarray:
    pad = np.pad(x, [(width // 2, width // 2)] + [(0, 0)] * (x.ndim - 1), mode="edge")
    kernel = np.ones(width) / width
    if x.ndim == 1:
        return np.convolve(pad, kernel, mode="valid")
    return np.stack([np.convolve(pad[:, j], kernel, mode="valid") for j in range(x.shape[1])], 1)


def render(rng: np.random.Generator, gen: torch.Generator, rows: int, length: int, sp: Mapping,
           sample_rate: int, device) -> torch.Tensor:
    """``rows`` speech-like utterances of ``length`` samples, ``[rows,
    length]`` float32 on ``device``, each scaled to a peak of 0.5."""
    steps = length // CONTROL_HOP + 2
    tracks = [_segments(rng, steps, sp) for _ in range(rows)]

    def track(name, smooth=True):
        a = np.stack([_smooth(t[name]) if smooth else t[name] for t in tracks]).astype(np.float32)
        x = torch.from_numpy(a).to(device)
        x = x[:, None] if x.dim() == 2 else x.transpose(1, 2)
        y = F.interpolate(x, size=steps * CONTROL_HOP, mode="linear", align_corners=False)
        return y[..., :length]

    kind = np.stack([t["kind"] for t in tracks])
    voiced = torch.from_numpy((kind == 1).astype(np.float32)).to(device)
    unvoiced = torch.from_numpy((kind == 2).astype(np.float32)).to(device)
    masks = F.interpolate(torch.stack([voiced, unvoiced], 1), size=steps * CONTROL_HOP,
                          mode="linear", align_corners=False)[..., :length]
    f0 = track("f0")[:, 0]
    gain = track("gain")[:, 0]
    formants = track("formants")  # [rows, 3, length]
    phase = torch.cumsum(f0.double() / sample_rate, dim=-1)
    phase = (phase - torch.floor(phase)).float()
    bandwidths = torch.tensor(sp["bandwidths"], device=device)[None, :, None]
    voiced_wave = torch.zeros(rows, length, device=device)
    for k in range(1, HARMONICS + 1):
        fk = f0 * k
        env = torch.exp(-(((fk[:, None] - formants) / bandwidths) ** 2)).sum(1) + 0.02 / k
        env = env * (fk < 0.45 * sample_rate)
        voiced_wave += env * torch.sin(2.0 * math.pi * torch.remainder(phase * k, 1.0))
    noise = torch.randn(rows, length + 1, device=device, generator=gen)
    bright = noise[:, 1:] - 0.9 * noise[:, :-1]
    wave = gain * (masks[:, 0] * voiced_wave / 4.0 + masks[:, 1] * bright) + 1e-3 * noise[:, 1:]
    return 0.5 * wave / wave.abs().amax(-1, keepdim=True)


@dataclasses.dataclass
class Traffic:
    """The requests of one run: the first cycle's utterances and the
    dictionary's audio, made in set-up."""

    params: Mapping
    seed: int
    sample_rate: int
    lengths: List[int]
    cycle: List[np.ndarray]  # the first cycle's waves, in request order
    order: List[List[int]]  # per cycle: the length index of each request
    target: np.ndarray  # [utterances, frames * hop] the target speaker's audio

    def request(self, i: int) -> Request:
        """The ``i``-th request of the closed loop."""
        n = len(self.lengths)
        c = i // n
        while c >= len(self.order):
            self.order.append(cycle_order(self.seed, len(self.order), n))
        j = self.order[c][i % n]
        wave = self.cycle[self.order[0].index(j)]
        shifts = self.params["pitch_shifts"]
        return Request(i, self.lengths[j], wave, float(shifts[i % len(shifts)]),
                       (int(self.seed) * 1_000_003 + i) % 2**31)

    def warm_requests(self, hop: int, bucket_frames: int) -> List[Request]:
        """One request of the first cycle for each bucket length of the
        cycle: the shapes that set-up warms."""
        first = {}
        for i in range(len(self.lengths)):
            r = self.request(i)
            first.setdefault(bucket(r.length, hop, bucket_frames), r)
        return [first[b] for b in sorted(first)]


def bucket(length: int, hop: int, bucket_frames: int) -> int:
    """The padded length the converter gives ``length`` samples: the next
    multiple of ``bucket_frames`` frames."""
    step = hop * bucket_frames
    return -(-length // step) * step


def make(params: Mapping, seed: int, audio: Mapping, device) -> Traffic:
    """Everything a run's traffic needs, from ``seed``."""
    sr, hop = audio["sample_rate"], audio["hop_size"]
    lengths = cycle_lengths(params, sr)
    first = cycle_order(seed, 0, len(lengths))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_SPACE)
    rng = _rng(seed, 0)
    sp = params["speech"]
    cycle = [render(rng, gen, params["batch"], lengths[j], sp, sr, device).cpu().numpy()
             for j in first]
    d = params["dictionary"]
    target = render(_rng(seed, 1), gen, d["utterances"], d["frames"] * hop, sp, sr, device)
    return Traffic(params, int(seed), sr, lengths, cycle, [first], target.cpu().numpy())
