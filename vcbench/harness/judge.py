"""The comparison that decides ``correct``.

The window's requests run through ``VoiceConverter.convert`` at their timed
sizes. Once the window has closed, a sample of them drawn from the seed (with
the longest) runs once more through the same call with ``stages=``; its output
must equal the window's bit for bit (``rerun``), which makes the stages those
of the timed path. The plain reference (`vcbench/reference/`, float64) then
judges each stage from the program's own input to it, because two stages
cannot be compared end to end: a kNN or pitch-class choice at a near tie
flips on the last bit of its scores, and the serving profile's bf16 U-Net is
chaotic. Each number is the worst over the sampled requests:

- ``content``: the encoder's content (spectrogram and encoder, from the
  reference's own spectrogram of the padded input), max error over the
  reference's peak.
- ``f0_gap``: the pitch classifier and the pitch shift. Each frame's f0 must
  be the softmax mean of some ``topk`` of the reference's ``topk + 2`` best
  pitch classes (within ``F0_RTOL``: fp32 logits of magnitude ~100 carry
  errors of ~1e-4, which move f0 by up to ~1e-5 of its value, and 1.1e-5
  was read on an H100); the number is how far the least logit
  of the best such set lies below the reference's ``topk``-th best, and
  ``NO_MATCH`` where no set fits.
- ``match_err``, ``match_gap``: kNN retrieval. Each matched frame is taken
  for the mean of the ``k`` of the reference's ``k + 2`` most similar
  dictionary rows whose mean lies nearest to it. ``match_err`` is how far it
  lies from that mean, its largest channel error over the rows' largest
  element (the configuration's limit holds the mean's precision: fp32 sums,
  or kernel H's bf16-rounded rows); ``match_gap`` is how far the least
  similarity of those rows lies below the reference's ``k``-th best.
- ``amps``, ``noise_kernel``: SourceNet from the program's matched frames and
  f0 and the reference's energy.
- ``harmonics``, ``noise``: the DSP source (kernels A and B with its seeded
  phases) from the program's f0, amplitudes and filter.
- ``out``: the window's converted waveform against the reference U-Net run
  on the program's source, matched frames and f0 and the reference's energy.

The fp32 stages (``content``, ``harmonics``, ``noise``) read the largest
absolute error over the reference's peak. The decoder's (``amps``,
``noise_kernel``, ``out``), which the serving profile computes in bf16, read
the worst row's relative rms error: a bf16 U-Net's single worst sample swings
from 0.009 to 0.052 of the peak between seeds while the fp8 control's may be
as low as 0.135, so the largest error cannot tell the two apart.
"""

from __future__ import annotations

import itertools
import sys
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..reference import model as ref

NUMBERS = ("rerun", "content", "f0_gap", "match_gap", "match_err", "amps", "noise_kernel", "harmonics",
           "noise", "out")
STAGES = ("content", "f0", "matched", "amps", "noise_kernel", "source")
F0_RTOL = 1e-4
NO_MATCH = 2.0
ROWS_PER_BLOCK = 4


def sample(lengths: Sequence[int], count: int, seed: int) -> List[int]:
    """Indices of the requests to check among ``lengths`` (those of the
    first requests of the window): the longest, and ``count - 1`` others
    drawn from the seed."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    rng = np.random.default_rng([int(seed) % 2**63, 99])
    picked = rng.choice(rest, size=min(count - 1, len(rest)), replace=False)
    return sorted([longest] + [int(i) for i in picked])


def sampled_requests(tr, params: Mapping, seed: int):
    """(the first ``trace_requests`` requests, the indices among them that
    are checked)."""
    pool = [tr.request(i) for i in range(params["trace_requests"])]
    return pool, sample([r.length for r in pool], params["check_requests"], seed)


class _Worst:
    """The running max of |got - want| and of |want| of one stage."""

    def __init__(self):
        self.err, self.peak = 0.0, 0.0

    def add(self, got, want):
        got = torch.as_tensor(got).to(want.device, want.dtype)
        self.err = max(self.err, float((got - want).abs().max()))
        self.peak = max(self.peak, float(want.abs().max()))

    def value(self) -> float:
        return self.err / self.peak if self.peak > 0 else float("inf")


class _WorstRow(_Worst):
    """The largest relative rms error of one row: ``||got - want|| /
    ||want||`` over each batch row's elements."""

    def __init__(self):
        self.worst = 0.0

    def add(self, got, want):
        got = torch.as_tensor(got).to(want.device, want.dtype)
        d = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1).clamp_min(1e-30)
        self.worst = max(self.worst, float(d.max()))

    def value(self) -> float:
        return self.worst


def _subsets(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """All ``k``-subsets of the last axis: (values, ids) ``[..., S, k]``."""
    combos = torch.tensor(list(itertools.combinations(range(vals.shape[-1]), k)),
                          device=vals.device)
    return vals[..., combos], ids[..., combos]


def _gap(err: torch.Tensor, least: torch.Tensor, kth: torch.Tensor, tol: float) -> torch.Tensor:
    """Per frame: ``kth - least`` of the best set whose error is within
    ``tol`` (the smallest such gap), ``NO_MATCH`` where none is."""
    fits = err <= tol
    gap = torch.where(fits, kth[..., None] - least, torch.full_like(least, float("inf")))
    gap = gap.min(-1).values
    return torch.where(torch.isinf(gap), torch.full_like(gap, NO_MATCH), gap.clamp_min(0.0))


def f0_gap(f0_prog, logits, pitch_shift: float, enc: Mapping) -> float:
    """A set's f0 within ``F0_RTOL`` of ``min_frequency`` may land on either
    side of the voicing threshold: both are accepted."""
    k, fmin = enc["pitch_topk"], enc["min_frequency"]
    vals, ids = torch.topk(logits, k + 2, dim=-1)
    sv, si = _subsets(vals, ids, k)
    raw = ref.f0_raw(sv, si, enc)
    voiced = torch.where(raw <= fmin, torch.zeros_like(raw), raw)
    other = torch.where(raw <= fmin, raw, torch.zeros_like(raw))
    got = f0_prog.to(raw.dtype)[..., None]
    err = None
    for f0 in (voiced, other):
        want = ref.shift_pitch(f0, pitch_shift)
        e = (got - want).abs() / want.abs().clamp_min(1e-30)
        err = e if err is None else torch.where((raw - fmin).abs() <= F0_RTOL * fmin,
                                                torch.minimum(err, e), err)
    gap = _gap(err, sv.min(-1).values, vals[..., k - 1], F0_RTOL)
    _note_misses("f0", gap, got[..., 0], ref.shift_pitch(voiced[..., 0], pitch_shift))
    return float(gap.max())


def _note_misses(stage: str, gap: torch.Tensor, got: torch.Tensor, want: torch.Tensor) -> None:
    """Name on standard error the first frames that no set of reference
    choices explains."""
    miss = (gap >= NO_MATCH).nonzero()
    for idx in miss[:3].tolist():
        i = tuple(idx)
        print(f"judge: {stage} frame {i} fits no near-best set: program {got[i].tolist()}, "
              f"reference's best {want[i].tolist()}", file=sys.stderr)


def match_numbers(matched_prog, content_prog, dictionary, k: int) -> Tuple[float, float]:
    """(``match_gap``, ``match_err``) of the worst frames."""
    sims = ref.cos_similarities(content_prog.to(dictionary.dtype), dictionary)
    vals, ids = torch.topk(sims, k + 2, dim=-1)
    del sims
    sv, _ = _subsets(vals, ids, k)
    combos = list(itertools.combinations(range(k + 2), k))
    pick = torch.zeros(len(combos), k + 2, dtype=dictionary.dtype, device=dictionary.device)
    for s, c in enumerate(combos):
        pick[s, list(c)] = 1.0 / k
    cand = dictionary[ids]  # [..., k + 2, C]
    means = torch.matmul(pick, cand)  # [..., S, C]
    scale = cand.abs().amax(-1)[..., torch.tensor(combos, device=ids.device)].amax(-1)
    got = matched_prog.to(dictionary.dtype)[..., None, :]
    err, best = ((got - means).abs().amax(-1) / scale.clamp_min(1e-30)).min(-1, keepdim=True)
    gap = vals[..., k - 1] - sv.min(-1).values.gather(-1, best)[..., 0]
    return float(gap.clamp_min(0.0).max()), float(err.max())


def compare(reference: "ref.Reference", dictionary: torch.Tensor, wave: np.ndarray,
            pitch_shift: float, noise_seed: int, stages: Mapping[str, torch.Tensor],
            out: np.ndarray) -> Dict[str, float]:
    """The numbers of one request: ``wave`` ``[B, L]`` as it was sent,
    ``stages`` the program's (over the bucket-padded length), ``out`` the
    converted ``[B, L]`` to judge."""
    cfg = reference.cfg
    hop, L = reference.hop, wave.shape[-1]
    padded = ref.bucket_pad(wave, hop, cfg["bucket_frames"])
    worst = {n: _Worst() for n in ("content", "harmonics", "noise")}
    worst.update({n: _WorstRow() for n in ("amps", "noise_kernel", "out")})
    choice = {"f0_gap": 0.0, "match_gap": 0.0, "match_err": 0.0}
    for r in range(0, wave.shape[0], ROWS_PER_BLOCK):
        rows = slice(r, r + ROWS_PER_BLOCK)
        st = {k: reference.tensor(v[rows]) for k, v in stages.items()}
        e, content, logits = reference.front(padded[rows])
        worst["content"].add(st["content"], content)
        choice["f0_gap"] = max(choice["f0_gap"], f0_gap(st["f0"], logits, pitch_shift,
                                                        cfg["encoder"]))
        del content, logits
        gap, err = match_numbers(st["matched"], st["content"], dictionary,
                                 cfg["retrieval"]["k"])
        choice["match_gap"], choice["match_err"] = (max(choice["match_gap"], gap),
                                                    max(choice["match_err"], err))
        amps, kernel = ref.source_net(st["matched"], st["f0"], e, reference.dec_w, hop)
        worst["amps"].add(st["amps"], amps)
        worst["noise_kernel"].add(st["noise_kernel"], kernel)
        # kernel B's hash counts the batch row: the block's rows sit at r..
        source = reference.dsp(st["f0"], st["amps"], st["noise_kernel"], noise_seed, row0=r)
        worst["harmonics"].add(st["source"][:, :-1], source[:, :-1])
        worst["noise"].add(st["source"][:, -1], source[:, -1])
        del source, amps, kernel
        y = ref.unet(st["matched"], st["f0"], e, st["source"], reference.dec_w, cfg["decoder"])
        worst["out"].add(out[rows], y[:, :L])
    return {**{n: w.value() for n, w in worst.items()}, **choice}


def worst_of(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {n: max(r[n] for r in readings) for n in readings[0]}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number is finite and within its limit (a number without one
    fails)."""
    return all(n in limits and np.isfinite(v) and v <= limits[n] for n, v in numbers.items())
