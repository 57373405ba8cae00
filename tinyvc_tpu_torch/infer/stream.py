"""Streaming conversion with SOLA crossfade stitching (counterpart of
`tinyvc_tpu/infer/stream.py`).

Each block of ``block_size`` samples rolls into a window of
``StreamConfig.input_size`` samples, and the whole window is converted
again (`infer/generator.py::convert_fn`): the encoder's GRN normalises over
the whole window, so the output depends on all of it. The new output is
aligned to the previous block's tail by normalised cross-correlation (SOLA:
a 4096-point rfft correlation over ``sola_search_size`` shifts, its
denominator a cumsum), then crossfaded by sin² windows or by
:func:`phase_vocoder`.

The step never waits for the card. The window and the SOLA tail stay on the
device, the shift is a device tensor that indexes the output (no
``.item()``), the block goes up through pinned memory with
``non_blocking=True``, and the output comes back into pinned memory behind
an event that :meth:`StreamConverter.collect_block` waits on. So with
``--pipeline D`` the host enqueues the next blocks while the card converts,
as JAX's asynchronous dispatch does. The random key is the JAX package's
(`utils/prng.py`), split once a block on the host; kernel B's seed is the
int32 that the JAX package's TPU path draws from the block's subkey.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import TinyVCConfig
from ..utils import prng
from ..utils.weights import decoder_from_jax, encoder_from_jax
from .generator import _resolve_device, convert_fn, convert_fn_sharded, exact_fp32

# block subkey -> (kernel B's int32 seed, noise phases [1, F, bins] or None)
NoiseFn = Callable[[np.ndarray], Tuple[int, Optional[torch.Tensor]]]


def hashed_noise(subkey: np.ndarray) -> Tuple[int, None]:
    """Kernel B's hashed phases seeded by ``randint(subkey, (), 0, int32
    max)``, the draw of the JAX package's TPU path
    (`tinyvc_tpu/models/decoder.py:427-429`)."""
    return prng.randint_int32(subkey), None


@dataclasses.dataclass
class StreamState:
    input_wav: torch.Tensor  # [input_size], on the device
    sola_buffer: torch.Tensor  # [crossfade_size], on the device
    key: np.ndarray  # [2] uint32, on the host

    @classmethod
    def init(cls, cfg, device, key: Optional[np.ndarray] = None) -> "StreamState":
        return cls(
            input_wav=torch.zeros(cfg.input_size, device=device),
            sola_buffer=torch.zeros(cfg.crossfade_size, device=device),
            key=prng.prng_key(0) if key is None else np.asarray(key, np.uint32),
        )


def _fade_windows(crossfade_size: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin² fade-in and its complement. The ramp is numpy's float32
    ``arange(0, 1, 1/n)``, which the JAX package's ``jnp.arange`` with a
    step is, values and length alike (a float arange can be one longer
    than n)."""
    t = torch.from_numpy(np.arange(0, 1, 1 / crossfade_size, dtype=np.float32)).to(device)
    fade_in = torch.sin(np.float32(math.pi) * t / 2) ** 2
    return fade_in, 1.0 - fade_in


def _angle(z: torch.Tensor) -> torch.Tensor:
    """``torch.angle`` with a zero bin's phase 0 whatever the signs of its
    zeros: the first block's tail is all zeros, and an FFT may return -0.0
    there (torch's does, XLA's does not), whose angle is pi."""
    return torch.atan2(z.imag, z.real + 0.0)


def phase_vocoder(a: torch.Tensor, b: torch.Tensor, fade_out: torch.Tensor,
                  fade_in: torch.Tensor) -> torch.Tensor:
    """Phase-aligned crossfade of two chunks (`tinyvc_tpu/infer/stream.py:55-80`)."""
    n = a.shape[0]
    window = torch.sqrt(fade_out * fade_in)
    fa = torch.fft.rfft(a * window)
    fb = torch.fft.rfft(b * window)
    absab = torch.abs(fa) + torch.abs(fb)
    scale = torch.full_like(absab, 2.0)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    absab = absab * scale
    phia = _angle(fa)
    phib = _angle(fb)
    deltaphase = phib - phia
    deltaphase = deltaphase - 2 * math.pi * torch.floor(deltaphase / (2 * math.pi) + 0.5)
    w = 2 * math.pi * torch.arange(n // 2 + 1, dtype=torch.float32, device=a.device) + deltaphase
    t = torch.arange(n, dtype=torch.float32, device=a.device)[:, None] / n
    return (a * fade_out**2 + b * fade_in**2
            + torch.sum(absab * torch.cos(w * t + phia), dim=-1) * window / n)


def sola_correlation(segment: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """SOLA's normalised cross-correlation (`tinyvc_tpu/infer/stream.py:
    138-155`) of the previous block's ``tail`` ``[crossfade]`` with
    ``segment`` ``[crossfade + search]`` at each of the ``search + 1``
    shifts: the numerator by a zero-padded rfft product, the sliding energy
    under the tail by a cumsum."""
    crossfade = tail.shape[0]
    search = segment.shape[0] - crossfade
    nfft = 1 << (crossfade + search - 1).bit_length()
    fx = torch.fft.rfft(segment, n=nfft)
    fb = torch.fft.rfft(tail, n=nfft)
    cor_nom = torch.fft.irfft(fx * torch.conj(fb), n=nfft)[:search + 1]
    sq = torch.cat([segment.new_zeros(1), torch.cumsum(segment * segment, 0)])
    cor_den = torch.sqrt(sq[crossfade:crossfade + search + 1] - sq[:search + 1] + 1e-8)
    return cor_nom / cor_den


def sola_stitch(window: torch.Tensor, tail: torch.Tensor, scfg, fades, shift=None):
    """SOLA on one converted ``window`` (`tinyvc_tpu/infer/stream.py:
    132-162`): the segment that ends ``last_delay_size`` before its end,
    its correlation with the previous block's ``tail``, the shift (the
    correlation's argmax, a device tensor, unless ``shift`` is given), and
    the segment from the shift crossfaded into the tail by ``fades``
    (`_fade_windows`), sin² or by :func:`phase_vocoder`. -> (block
    ``[block_size]``, the next tail ``[crossfade_size]``, the correlation
    ``[search + 1]``, the shift)."""
    block, crossfade = scfg.block_size, scfg.crossfade_size
    search, delay = scfg.sola_search_size, scfg.last_delay_size
    fade_in, fade_out = fades
    end = window.shape[0] - delay
    temp = window[end - block - crossfade - search:end]
    corr = sola_correlation(temp[:crossfade + search], tail)
    if shift is None:
        shift = torch.argmax(corr)  # stays on the device
    aligned = temp.index_select(0, shift + torch.arange(block + crossfade, device=temp.device))
    head = aligned[:crossfade]
    if scfg.use_phase_vocoder:
        head = phase_vocoder(tail, head, fade_out, fade_in)
    else:
        head = head * fade_in + tail * fade_out
    aligned = torch.cat([head, aligned[crossfade:]])
    return aligned[:block], aligned[block:], corr, shift


def make_stream_step(encoder, decoder, cfg: TinyVCConfig, device, mesh=None,
                     noise: NoiseFn = hashed_noise):
    """The per-block function ``(state, block [block_size] on the device,
    target [N, C], pitch_shift, stats=None) -> (state, out [block_size])``.
    With ``mesh`` (`parallel/mesh.py::Mesh`), ``target`` is this rank's
    ``(dictionary, mask)`` shard over the mesh's ``model`` axis and the
    window converts through `infer/generator.py::convert_fn_sharded`
    (JAX's BASELINE config 5): every rank of the model group converts the
    same window and returns the same block.
    ``noise`` gives each block's noise from the block's subkey: kernel B's
    seed by default; a test hands in the JAX package's CPU draw as phases.
    ``stats``, when given, receives the converted window ``window``, the
    normalised correlation over the shifts ``corr`` and the SOLA shift
    ``shift``, on the device."""
    scfg = cfg.stream
    block = scfg.block_size
    fades = _fade_windows(scfg.crossfade_size, device)

    def stream_step(state: StreamState, block_in: torch.Tensor, target: torch.Tensor,
                    pitch_shift: float, stats: Optional[Dict[str, torch.Tensor]] = None):
        key, subkey = prng.split(state.key)
        input_wav = torch.cat([state.input_wav[block:], block_in])
        seed, angle = noise(subkey)
        with exact_fp32():
            if mesh is None:
                y = convert_fn(encoder, decoder, input_wav[None], target, pitch_shift, seed, cfg,
                               noise_angle=angle)
            else:
                y = convert_fn_sharded(encoder, decoder, input_wav[None], *target, pitch_shift,
                                       seed, cfg, mesh, noise_angle=angle)
            y = y[0].float()

        out, tail, corr, shift = sola_stitch(y, state.sola_buffer, scfg, fades)
        if stats is not None:
            stats.update(window=y, corr=corr, shift=shift)
        return StreamState(input_wav=input_wav, sola_buffer=tail, key=key), out

    return stream_step


class StreamConverter:
    """Feed float blocks, get converted blocks (the JAX package's
    ``StreamConverter``, the reference's ``StreamInfer``), with the state on
    one device. The device defaults to CUDA and raises when CUDA is absent;
    the CPU runs only when asked for. ``target`` ``[N, C]`` is moved to the
    device once and never written. With ``mesh`` (a ``data=1`` grid: a
    stream is one row), the dictionary is padded over the ``model`` axis
    and this rank keeps only its shard (`parallel/sharded_knn.py`); every
    rank of the group steps the same blocks."""

    def __init__(
        self,
        enc_params: Mapping[str, Any],
        dec_params: Mapping[str, Any],
        target,
        cfg: TinyVCConfig | None = None,
        pitch_shift: float = 0.0,
        key: Optional[np.ndarray] = None,
        mesh=None,
        device: str | torch.device = "cuda",
        noise: NoiseFn = hashed_noise,
    ):
        self.cfg = cfg or TinyVCConfig()
        self.device = _resolve_device(device)
        self.encoder = encoder_from_jax(enc_params, self.cfg.encoder).to(self.device)
        self.decoder = decoder_from_jax(dec_params, self.cfg.decoder,
                                        self.cfg.audio).to(self.device)
        self.target = torch.as_tensor(target, dtype=torch.float32).to(self.device)
        if mesh is not None:
            from ..parallel.sharded_knn import dictionary_shard, pad_dictionary

            if mesh.data != 1:
                raise ValueError(f"a stream is one row: its mesh needs data=1, got {mesh.data}")
            padded, mask = pad_dictionary(self.target, mesh.model, self.cfg.retrieval.k)
            self.target = dictionary_shard(padded, mask, mesh)
        self.pitch_shift = float(np.float32(pitch_shift))
        self._step = make_stream_step(self.encoder, self.decoder, self.cfg, self.device, mesh,
                                      noise)
        self.state = StreamState.init(self.cfg.stream, self.device, key)
        self._pending: list = []

    def reset(self) -> None:
        """A new stream: zero window and tail, the key kept."""
        self.state = StreamState.init(self.cfg.stream, self.device, self.state.key)
        self._pending = []

    @property
    def block_size(self) -> int:
        return self.cfg.stream.block_size

    @property
    def latency_samples(self) -> int:
        """The algorithmic latency bound (reference `stream.py:47-57`)."""
        s = self.cfg.stream
        return s.input_size - s.block_size

    def _upload(self, block: np.ndarray) -> torch.Tensor:
        block = np.asarray(block, dtype=np.float32)
        if block.shape != (self.block_size,):
            raise ValueError(f"expected a block of {self.block_size} samples, got {block.shape}")
        host = torch.from_numpy(block)  # the step copies it into its window
        if self.device.type == "cpu":
            return host
        # pinned, so the copy is asynchronous; the caching host allocator
        # keeps the buffer until the copy has run
        return host.pin_memory().to(self.device, non_blocking=True)

    @torch.inference_mode()
    def step(self, block: np.ndarray,
             stats: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Enqueue one block; its output ``[block_size]`` on the device."""
        self.state, out = self._step(self.state, self._upload(block), self.target,
                                     self.pitch_shift, stats)
        return out

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """block ``[block_size]`` float32 -> converted ``[block_size]`` float32."""
        return self.step(block).cpu().numpy()

    # ---- pipelined dispatch ------------------------------------------------
    # submit_block returns once the block's work is enqueued; its output is
    # copied into pinned memory behind an event, so collecting block N - D
    # waits for that block only, not for the D blocks enqueued after it.

    def submit_block(self, block: np.ndarray) -> None:
        """Enqueue ``block``; pair with :meth:`collect_block`."""
        out = self.step(block)
        if self.device.type == "cpu":
            self._pending.append((out, None))
            return
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._pending.append((host, done))

    def collect_block(self) -> np.ndarray:
        """The oldest in-flight output (waits until it is ready)."""
        host, done = self._pending.pop(0)
        if done is not None:
            done.synchronize()
        return host.numpy().copy()

    def in_flight(self) -> int:
        return len(self._pending)

    def process_block_pipelined(self, block: np.ndarray, depth: int = 1) -> Optional[np.ndarray]:
        """Submit ``block``; return the output of the block ``depth`` calls
        ago (None for the first ``depth`` calls). ``depth=0`` is
        :meth:`process_block`."""
        self.submit_block(block)
        if len(self._pending) > depth:
            return self.collect_block()
        return None

    def drain(self):
        """Collect every in-flight output (end of stream)."""
        while self._pending:
            yield self.collect_block()
