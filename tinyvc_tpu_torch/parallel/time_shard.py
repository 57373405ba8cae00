"""Chunked long-utterance conversion on one device (counterpart of
`tinyvc_tpu/parallel/time_shard.py::time_batched_convert` with
``native=True``, its ``_time_batched_native`` body).

The utterance is cut into ``S`` equal chunks of ``seg`` frames; each chunk
row carries a halo of ``H`` frames a side, and the rows run as one ordinary
batch ``[S, ...]`` through the whole pipeline, so every kernel of the
whole-utterance path runs at the chunk shapes (G and H under the serving
profile at ``B*F = S*(seg + 2H)`` frames). Three things keep the chunks one
utterance:

1. GRN's statistic leaves the halos out and sums over the rows
   (`models/layers.py::GRN`, :func:`grn_time_chunks`): the encoder's with
   ``H`` frames, the SourceNet's with the source margin ``M``.
2. The harmonic phase of each row is seeded (``phase0``, kernel A's seed)
   from the wrapped global prefix of the stitched core f0's per-frame sums,
   minus what the row's oscillator integrates over its margin frames before
   the second core frame.
3. The noise phases come from a table indexed by global frame
   (`utils/prng.py::per_frame_angles_torch`), or from ``noise_angle``.

The output is invariant to the chunk count up to fp32 noise and agrees with
the whole-utterance conversion at the mel level (JAX's parity metric), not
at the waveform: the utterance's edge frames see reflected halo context
instead of each op's own edge padding, and the absolute harmonic phase
depends on them.

On the card kernel A integrates in closed form where the JAX oscillator
runs a two-level fp32 scan, so the seed's cancellation of the margin
frames, exact there, is exact here only to A's distance from that scan over
the ``M + 2`` margin frames. The seed formula is JAX's on both devices.

:func:`time_sharded_convert` (JAX's mesh path) runs the same math with the
rows spread over a mesh axis, one row a rank: GRN's statistic is summed
over the axis's group (an ``all_reduce``), the core f0 is gathered from
every rank for the phase prefix, each rank takes its own rows' seeds and
noise windows, and every rank gathers the whole waveform.

JAX's ``native=False`` lowering (a ``vmap`` over the per-shard function,
kept there as an A/B ablation equal to the native body within 1e-5) is not
ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import TinyVCConfig
from ..dsp.energy import estimate_energy
from ..dsp.interp import linear_interp_last
from ..dsp.phase import wrapped_exclusive_prefix
from ..dsp.pitch import shift_frequency
from ..kernels.noise import oscillate_noise_hashed
from ..kernels.oscillator import oscillator_bank
from ..models.decoder import Decoder
from ..models.encoder import Encoder
from ..models.layers import grn_time_chunks
from ..utils.prng import per_frame_angles_torch
from .mesh import Mesh

# Stages shorter than this run the U-Net's modules, not the chain kernels,
# as the JAX package's chunked path asks (`time_shard.py:473-481`).
CHUNK_KERNEL_MIN_LEN = 8192


def frame_sum_constants(frame_size: int):
    """The per-frame sum of the linear f0 interpolation as a 3-tap filter:
    (c_prev, c_cur, c_next) such that a frame's phase increment is
    ``(c_prev f0[p-1] + c_cur f0[p] + c_next f0[p+1]) / sr``."""
    a = (np.arange(frame_size) + 0.5) / frame_size - 0.5
    neg, pos = a < 0, a >= 0
    c_prev = float((-a[neg]).sum())
    c_cur = float((1.0 + a[neg]).sum() + (1.0 - a[pos]).sum())
    c_next = float(a[pos].sum())
    return c_prev, c_cur, c_next


def angle_shards(noise_angle: torch.Tensor, S: int, seg: int, M: int) -> torch.Tensor:
    """Each row's window ``[S, seg + 2M, bins]`` of the ``[F, bins]`` noise
    phase table, the table edge-padded by ``M`` frames a side."""
    pad = torch.cat([noise_angle[:1].expand(M, -1), noise_angle,
                     noise_angle[-1:].expand(M, -1)])
    return torch.stack([pad[i * seg: i * seg + seg + 2 * M] for i in range(S)])


def chunk_windows(wave: torch.Tensor, S: int, seg: int, H: int, hop: int) -> torch.Tensor:
    """``[L]`` -> the rows' windows ``[S, (seg + 2H) * hop]``: the utterance
    reflect-padded by ``H`` frames a side (each sample repeated at the edge
    when the pad is not shorter than the utterance), chunk ``i`` starting
    at frame ``i * seg``."""
    pad = H * hop
    if pad < wave.shape[0]:
        wave_p = F.pad(wave.view(1, 1, -1), (pad, pad), mode="reflect").view(-1)
    else:  # degenerate: the utterance is not longer than the halo
        wave_p = torch.cat([wave[:1].expand(pad), wave, wave[-1:].expand(pad)])
    return wave_p.unfold(0, (seg + 2 * H) * hop, seg * hop).contiguous()


def _rate(sample_rate: int, like: torch.Tensor) -> torch.Tensor:
    """The sample rate as a 0-dim fp32 tensor on ``like``'s device. Divided
    by a Python number, a CUDA tensor is multiplied by the number's fp32
    reciprocal, one more rounding, and its bias is the same in every frame,
    so the prefix sums it over the utterance (1.28e-4 cycles from the
    float64 truth at 60 s on the H100, against 3.6e-5 on the CPU); divided
    by a tensor it gets the IEEE quotient, as on the CPU."""
    return torch.tensor(float(sample_rate), dtype=torch.float32, device=like.device)


def chunk_phase_seeds(f0_h: torch.Tensor, prefix: torch.Tensor, seg: int, M: int, hop: int,
                      sample_rate: int, first_row: int = 0) -> torch.Tensor:
    """Each row's oscillator seed ``[S]`` (cycles in [0, 1)): the global
    prefix at the row's second core frame minus the wrapped phase the
    JAX oscillator's two-level scan integrates over the row's first ``M +
    2`` frames of ``f0_h`` ``[S, seg + 2M + 2]``, so that the row's phase at
    that frame is the prefix (`time_shard.py:433-443`). The rows are the
    utterance's ``first_row``, ``first_row + 1``, ..."""
    S = f0_h.shape[0]
    margin = linear_interp_last(f0_h[:, :M + 4], (M + 4) * hop)
    d = margin / _rate(sample_rate, margin)
    msums = torch.cumsum(d.reshape(S, M + 4, hop), dim=-1)[..., -1]
    local_off = wrapped_exclusive_prefix(msums - torch.floor(msums))[:, M + 2]
    starts = (first_row + torch.arange(S, device=f0_h.device)) * seg + 1
    return torch.remainder(prefix[starts] - local_off, 1.0)


def _gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The rows ``[Sl, ...]`` of every rank of ``group``, in rank order:
    ``[size * Sl, ...]``."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _overlap_save(encoder, decoder, wave, target, pitch_shift, key, cfg, S, halo_frames,
                  filter_halo, noise_angle, stages, rows: range, group=None, size: int = 1):
    """The chunk rows ``rows`` of the utterance's ``S`` -> their cores
    ``[len(rows), seg * hop]``. With ``group`` (of ``size`` ranks, each
    holding as many rows, in order) GRN's statistic and the core f0 span
    every rank's rows; without, ``rows`` are all ``S``."""
    from ..infer.generator import filter_infer, serving_match_features, serving_spectrogram

    a = cfg.audio
    hop = a.hop_size
    L = wave.shape[-1]
    if L % (S * hop):
        raise ValueError(f"the utterance's {L} samples are not a multiple of shards * hop = "
                         f"{S * hop}: bucket it first")
    seg = L // hop // S
    H, M = halo_frames, filter_halo + 4  # +4 frames for the ISTFT's overlap-add
    if H < M + 2:
        raise ValueError(f"halo_frames {H} must cover the filter margin {M} + 2")

    windows = chunk_windows(wave, S, seg, H, hop)[rows.start:rows.stop]
    spec = serving_spectrogram(windows, cfg)  # [Sl, seg + 2H, bins]
    energy = estimate_energy(windows, a.energy_frame_size)
    with grn_time_chunks(encoder, H, True, group):
        content, f0 = encoder.infer(spec)
    matched = serving_match_features(content, target, cfg)
    f0 = shift_frequency(f0, pitch_shift)  # [Sl, seg + 2H]

    # the global phase prefix, from the core f0 stitched by a reshape
    c_prev, c_cur, c_next = frame_sum_constants(hop)
    f0_core = f0[:, H:H + seg]
    if group is not None:
        f0_core = _gather_rows(f0_core, group, size)
    f0_glob = f0_core.reshape(S * seg)
    f0_pad = torch.cat([f0_glob[:1], f0_glob, f0_glob[-1:]])
    frame_sums = ((c_prev * f0_pad[:-2] + c_cur * f0_pad[1:-1] + c_next * f0_pad[2:])
                  / _rate(a.sample_rate, f0))
    prefix = wrapped_exclusive_prefix(torch.remainder(frame_sums, 1.0)[None])[0]

    # the source over the window [H - M, H + seg + M)
    sw0, swf = H - M, seg + 2 * M
    content_w = matched[:, sw0:sw0 + swf]
    f0_w = f0[:, sw0:sw0 + swf]
    energy_w = energy[:, sw0 * hop:(sw0 + swf) * hop]
    with grn_time_chunks(decoder.source_net, M, True, group):
        amps, kernel = decoder.source_net(content_w, f0_w, energy_w)

    # harmonics over [sw0 - 1, sw0 + swf + 1), cropped by a hop a side: the
    # amplitudes edge-replicated by one frame a side, so that their
    # interpolation over the kept samples is the clamped one of swf frames
    f0_h = f0[:, sw0 - 1:sw0 + swf + 1].contiguous()
    phase0 = chunk_phase_seeds(f0_h, prefix, seg, M, hop, a.sample_rate, rows.start)
    amps_h = torch.cat([amps[:, :1], amps, amps[:, -1:]], dim=1).contiguous()
    harm = oscillator_bank(f0_h, amps_h, hop, a.sample_rate, phase0=phase0)[:, :, hop:-hop]

    if noise_angle is not None:
        angle = angle_shards(noise_angle.float(), S, seg, M)[rows.start:rows.stop]
    else:
        first = torch.arange(rows.start, rows.stop, device=f0.device)[:, None]
        frames_g = (first * seg - M + torch.arange(swf, device=f0.device)[None]).reshape(-1)
        angle = per_frame_angles_torch(key, frames_g, a.fft_bin).reshape(len(rows), swf,
                                                                           a.fft_bin)
    noise = oscillate_noise_hashed(kernel.contiguous(), 0, hop, a.n_fft,
                                   angle=angle.contiguous())  # [Sl, swf * hop]

    out, _ = filter_infer(decoder, content_w, f0_w, energy_w, harm, noise, cfg,
                          kernel_min_len=CHUNK_KERNEL_MIN_LEN)
    if stages is not None:
        stages.update(f0=f0, f0_h=f0_h, phase0=phase0, prefix=prefix, angle=angle, out=out)
    return out[:, M * hop:(M + seg) * hop]


def time_batched_convert(
    encoder: Encoder,
    decoder: Decoder,
    wave: torch.Tensor,
    target: torch.Tensor,
    pitch_shift: float,
    key: np.ndarray,
    cfg: TinyVCConfig,
    shards: int = 4,
    halo_frames: int = 96,
    filter_halo: int = 32,
    noise_angle: Optional[torch.Tensor] = None,
    stages: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Chunked conversion ``[L] -> [L]`` of one utterance in ``shards``
    chunk rows, with the modules' weights as they are (their GRNs take the
    chunk settings for the call). ``L`` must be a multiple of ``shards *
    hop``. ``key`` (``[2]`` uint32, `utils/prng.py::prng_key`) indexes the
    per-global-frame noise phases; ``noise_angle`` ``[F, bins]`` replaces
    them. ``stages``, when given, receives the rows' ``f0`` ``[S, seg +
    2H]``, the oscillator's ``f0_h`` and ``phase0``, ``prefix`` ``[F]``,
    the ``angle`` table and the rows' U-Net output ``out``."""
    core = _overlap_save(encoder, decoder, wave, target, pitch_shift, key, cfg, shards,
                         halo_frames, filter_halo, noise_angle, stages, range(shards))
    return core.reshape(wave.shape[-1])


def time_sharded_convert(
    mesh: Mesh,
    encoder: Encoder,
    decoder: Decoder,
    wave: torch.Tensor,
    target: torch.Tensor,
    pitch_shift: float,
    key: np.ndarray,
    cfg: TinyVCConfig,
    halo_frames: int = 96,
    filter_halo: int = 32,
    axis: str = "data",
    noise_angle: Optional[torch.Tensor] = None,
    stages: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Chunked conversion ``[L] -> [L]`` sharded along ``axis`` of ``mesh``
    (`tinyvc_tpu/parallel/time_shard.py::time_sharded_convert`): ``S`` =
    the axis's size chunk rows, rank ``i`` of the axis converting row
    ``i``. Every rank passes the whole utterance ``wave``, the whole
    ``target`` and the same ``key`` (or ``noise_angle`` ``[F, bins]``),
    and every rank returns the whole waveform. ``stages`` receives this
    rank's row as :func:`time_batched_convert` gives them."""
    group, S, i = mesh.axis(axis)
    core = _overlap_save(encoder, decoder, wave, target, pitch_shift, key, cfg, S, halo_frames,
                         filter_halo, noise_angle, stages, range(i, i + 1), group, S)
    return _gather_rows(core, group, S).reshape(wave.shape[-1])
