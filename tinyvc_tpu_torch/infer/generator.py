"""Whole-utterance conversion (counterpart of `tinyvc_tpu/infer/generator.py`).

``convert_fn`` is the pipeline: spectrogram (:func:`serving_spectrogram`)
-> encoder -> kNN match (:func:`serving_match_features`) -> pitch shift ->
decoder (:func:`decode_infer`), with the energy estimate alongside.
``VoiceConverter`` holds the weights on one device and pads each request to
its 64-frame bucket, as the JAX package does (the padding changes the GRN
statistics, so it is part of the result).

Profiles: ``TinyVCConfig()`` is fp32 throughout; ``serving_config()`` runs
the decoder in bf16 (SourceNet's dense and ConvNeXt layers, the U-Net and
its resamples, kernels C-F in bf16) and, by the JAX package's gates, the
spectrogram kernel G and the kNN kernel H.

Numerics: the JAX package's fp32 profile is exact fp32, so every
convolution and matmul here runs with TF32 off (see :func:`exact_fp32`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import TinyVCConfig
from ..dsp.energy import estimate_energy
from ..dsp.padding import autopad_waveform, pad_to_bucket
from ..dsp.pitch import shift_frequency
from ..dsp.stft import spectrogram
from ..kernels import spectrogram as spectrogram_kernel
from ..kernels.knn import match_features_knn
from ..models.decoder import Decoder, pack_source
from ..models.encoder import Encoder
from ..ops.fused_filternet import filternet_fused_apply
from ..ops.retrieval import match_features
from ..utils.prng import kernel_b_seed, prng_key
from ..utils.weights import decoder_from_jax, encoder_from_jax

KNN_KERNEL_MAX_BYTES = 12 * 2**20  # the JAX gate: the fp32 dictionary fits VMEM


@contextlib.contextmanager
def exact_fp32():
    """Run cuDNN convolutions and CUDA matmuls in full fp32 (TF32 off), and
    bf16 matmuls with fp32 reductions, for the duration, restoring the
    matmul flags afterwards. TF32 keeps ~3 decimal digits, enough to flip
    kNN neighbours."""
    matmul = torch.backends.cuda.matmul
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        prev = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            yield
        finally:
            matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = prev


def serving_spectrogram(wave: torch.Tensor, cfg: TinyVCConfig) -> torch.Tensor:
    """The spectrogram of the serving path (`tinyvc_tpu/infer/generator.py
    ::serving_spectrogram`): ``cfg.audio.spectrogram_impl`` "pallas" takes
    kernel G (its plain version on CPU tensors), "xla" the fp32 rfft of
    `dsp/stft.py`; "auto" takes kernel G under the bf16 decoder, on CUDA
    tensors, at ``B*F >= 2048`` frames, where the JAX package takes its
    kernel (under bf16, off the CPU backend, at the same size)."""
    impl = cfg.audio.spectrogram_impl
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"spectrogram_impl must be 'auto', 'pallas' or 'xla', got {impl!r}")
    B, F = wave.shape[0], wave.shape[1] // cfg.audio.hop_size
    if impl == "auto":
        use_kernel = (cfg.decoder.compute_dtype == "bfloat16" and wave.device.type == "cuda"
                      and B * F >= 2048)
    else:
        use_kernel = impl == "pallas"
    fn = spectrogram_kernel.spectrogram if use_kernel else spectrogram
    return fn(wave, cfg.audio.n_fft, cfg.audio.hop_size)


def serving_match_features(content: torch.Tensor, target: torch.Tensor,
                           cfg: TinyVCConfig) -> torch.Tensor:
    """kNN matching of the serving path (`tinyvc_tpu/infer/generator.py
    ::serving_match_features`): kernel H (`kernels/knn.py`, a mean of
    bf16-rounded dictionary rows) when ``cfg.retrieval.impl`` is not "xla",
    the dictionary is one 2-D ``[N, C]`` of at most 12 MiB in fp32 and the
    decoder runs in bf16; else the fp32 `ops/retrieval.py`. The gate decides
    which function runs, as in the JAX package."""
    r = cfg.retrieval
    if r.impl not in ("auto", "xla"):
        raise ValueError(f"retrieval impl must be 'auto' or 'xla', got {r.impl!r}")
    use_kernel = (r.impl != "xla" and target.dim() == 2
                  and target.shape[0] * target.shape[1] * 4 <= KNN_KERNEL_MAX_BYTES
                  and cfg.decoder.compute_dtype == "bfloat16")
    if use_kernel:
        return match_features_knn(content, target, k=r.k, alpha=r.alpha, metric=r.metric)
    return match_features(content, target, k=r.k, alpha=r.alpha, metric=r.metric)


def encode_fn(encoder: Encoder, wave: torch.Tensor, cfg: TinyVCConfig):
    """wave ``[B, L]`` -> (content ``[B, F, C]``, f0 ``[B, F]``)."""
    wave = autopad_waveform(wave, cfg.audio.hop_size)
    spec = serving_spectrogram(wave, cfg)
    return encoder.infer(spec)


def decode_infer(
    decoder: Decoder,
    content: torch.Tensor,
    f0: torch.Tensor,
    energy: torch.Tensor,
    noise_seed: int,
    cfg: TinyVCConfig,
    noise_angle: Optional[torch.Tensor] = None,
    stages: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """``Decoder.infer`` with the U-Net picked by :func:`filter_infer`:
    the fused U-Net (`ops/fused_filternet.py`, kernels C-F) on the packed
    source, or the layer-by-layer :class:`FilterNet`. ``noise_seed`` is
    kernel B's int32 seed itself (:meth:`VoiceConverter.convert` derives it
    from the JAX key).
    ``stages`` receives SourceNet's harmonic amplitudes ``amps`` and noise
    filter ``noise_kernel`` and the source ``[B, H+2, L]``."""
    amps, kernel = decoder.source_net(content, f0, energy)
    harmonics, noise = decoder.dsp_parts(f0, amps, kernel, noise_seed, noise_angle)
    out, source = filter_infer(decoder, content, f0, energy, harmonics, noise, cfg)
    if stages is not None:
        stages.update(amps=amps, noise_kernel=kernel, source=source)
    return out


def filter_infer(
    decoder: Decoder,
    content: torch.Tensor,
    f0: torch.Tensor,
    energy: torch.Tensor,
    harmonics: torch.Tensor,
    noise: torch.Tensor,
    cfg: TinyVCConfig,
    kernel_min_len: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The U-Net over the source ``[harmonics; noise]``, picked by
    ``cfg.decoder.use_fused_filter``: "on", or "auto" on CUDA tensors, packs
    the source for the fused stem (`models/decoder.py::pack_source`) and
    runs the fused U-Net with ``kernel_min_len``; "off", or "auto" on CPU
    tensors, the layer-by-layer :class:`FilterNet`. -> (waveform ``[B,
    L]``, the source ``[B, H+2, L]``)."""
    flag = cfg.decoder.use_fused_filter
    if flag not in ("auto", "on", "off"):
        raise ValueError(f"use_fused_filter must be 'auto', 'on' or 'off', got {flag!r}")
    n_src = harmonics.shape[1] + 1
    if flag == "on" or (flag == "auto" and energy.device.type == "cuda"):
        packed = pack_source(harmonics, noise, energy)
        out = filternet_fused_apply(decoder.filter_net, cfg.decoder, content, f0, energy, packed,
                                    kernel_min_len=kernel_min_len)
        return out, packed[:, :n_src]
    source = pack_source(harmonics, noise)
    return decoder.filter_net(content, f0, energy, source), source


def convert_fn(
    encoder: Encoder,
    decoder: Decoder,
    wave: torch.Tensor,
    target: torch.Tensor,
    pitch_shift: float,
    noise_seed: int,
    cfg: TinyVCConfig,
    noise_angle: Optional[torch.Tensor] = None,
    stages: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """``[B, L]`` waveforms and a ``[N, C]`` (or ``[B, N, C]``) dictionary ->
    converted ``[B, L']`` with L' = L rounded up to a whole frame.

    ``noise_seed`` is kernel B's int32 seed of the hashed noise phases;
    ``noise_angle`` ``[B, F, bins]`` replaces them. ``stages``, when given,
    receives the intermediate tensors (the frame-padded input, spec, content,
    f0, matched, energy, amps, noise_kernel, source, out) for inspection."""
    return _convert(encoder, decoder, wave, lambda c: serving_match_features(c, target, cfg),
                    pitch_shift, noise_seed, cfg, noise_angle, stages)


def convert_fn_sharded(
    encoder: Encoder,
    decoder: Decoder,
    wave: torch.Tensor,
    dictionary: torch.Tensor,
    mask: torch.Tensor,
    pitch_shift: float,
    noise_seed: int,
    cfg: TinyVCConfig,
    mesh,
    noise_angle: Optional[torch.Tensor] = None,
    stages: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """:func:`convert_fn` with the kNN dictionary's rows sharded over the
    mesh's ``model`` axis (`tinyvc_tpu/infer/generator.py::
    convert_fn_sharded`): ``wave`` is this rank's rows, ``dictionary`` and
    ``mask`` this rank's shard of the padded dictionary
    (`parallel/sharded_knn.py::pad_dictionary`, ``dictionary_shard``).
    Each rank runs the spectrogram, the encoder, the sharded match
    (`parallel/sharded_knn.py::sharded_match_features`, the similarity
    product in fp32, not kernel H: JAX's path), the pitch shift and the
    decoder on its rows."""
    from ..parallel.sharded_knn import sharded_match_features

    r = cfg.retrieval
    return _convert(encoder, decoder, wave, lambda c: sharded_match_features(
        mesh, c, dictionary, mask, k=r.k, alpha=r.alpha, metric=r.metric),
        pitch_shift, noise_seed, cfg, noise_angle, stages)


def _convert(encoder, decoder, wave, match, pitch_shift, noise_seed, cfg, noise_angle, stages):
    """The pipeline of both converters, ``match`` the kNN step."""
    wave = autopad_waveform(wave, cfg.audio.hop_size)
    spec = serving_spectrogram(wave, cfg)
    energy = estimate_energy(wave, cfg.audio.energy_frame_size)
    content, f0 = encoder.infer(spec)
    matched = match(content)
    f0 = shift_frequency(f0, pitch_shift)
    out = decode_infer(decoder, matched, f0, energy, noise_seed, cfg, noise_angle, stages)
    if stages is not None:
        stages.update(input=wave, spec=spec, content=content, f0=f0, matched=matched,
                      energy=energy, out=out)
    return out


def _resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class VoiceConverter:
    """Weights on one device plus bucketed host entry points.

    ``enc_params``/``dec_params`` are JAX parameter trees of numpy arrays
    (`utils/weights.py::load_npz`); ``dec_params=None`` builds an encoder
    only (`infer/index.py`), which converts nothing. The device defaults to
    CUDA and raises when CUDA is absent; the CPU runs only when asked for.

    One call at a time: :meth:`convert_chunked` sets the GRN settings of
    the converter's own modules for its duration
    (`models/layers.py::grn_time_chunks`), so any other call on the same
    converter meanwhile (another thread) would take chunk statistics. Give
    each thread a converter of its own."""

    def __init__(
        self,
        enc_params: Mapping[str, Any],
        dec_params: Optional[Mapping[str, Any]],
        cfg: TinyVCConfig | None = None,
        device: str | torch.device = "cuda",
        bucket_frames: int = 64,
    ):
        self.cfg = cfg or TinyVCConfig()
        self.device = _resolve_device(device)
        self.encoder = encoder_from_jax(enc_params, self.cfg.encoder).to(self.device)
        self.decoder = None if dec_params is None else decoder_from_jax(
            dec_params, self.cfg.decoder, self.cfg.audio).to(self.device)
        self.bucket_frames = bucket_frames

    def _padded(self, wave: np.ndarray):
        wave = np.atleast_2d(np.asarray(wave, dtype=np.float32))
        padded, L = pad_to_bucket(wave, self.cfg.audio.hop_size, self.bucket_frames)
        return torch.from_numpy(padded).to(self.device), L

    @torch.inference_mode()
    def encode(self, wave: np.ndarray):
        """``[B, L]`` or ``[L]`` -> (content ``[B, F, C]``, f0 ``[B, F]``) on
        the device, padding stripped."""
        x, L = self._padded(wave)
        with exact_fp32():
            content, f0 = encode_fn(self.encoder, x, self.cfg)
        frames = L // self.cfg.audio.hop_size
        return content[:, :frames], f0[:, :frames]

    def build_dictionary(self, wave: np.ndarray) -> torch.Tensor:
        """A target speaker's waveform -> ``[N, C]`` kNN dictionary."""
        content, _ = self.encode(wave)
        return content.reshape(-1, content.shape[-1])

    @torch.inference_mode()
    def convert(
        self,
        wave: np.ndarray,
        target: np.ndarray | torch.Tensor,
        pitch_shift: float = 0.0,
        seed: int = 0,
        stages: Optional[Dict[str, torch.Tensor]] = None,
    ) -> np.ndarray:
        """``[B, L]`` or ``[L]`` waveform -> converted waveform of the same
        shape. ``target`` is the ``[N, C]`` dictionary; pass it as a tensor
        on this converter's device (as :meth:`build_dictionary` returns it)
        to keep it from being copied there with every request.

        ``seed`` means what ``key=jax.random.PRNGKey(seed)`` means to the
        JAX package's ``VoiceConverter.convert`` (whose default key is
        ``PRNGKey(0)``): kernel B gets the int32 ``jax.random.randint(key,
        (), 0, int32 max)`` that the JAX decoder draws for its noise kernel
        (`tinyvc_tpu/models/decoder.py:427-429`), computed here without JAX
        for threefry2x32 keys with ``jax_threefry_partitionable`` on and x64
        off (`utils/prng.py::kernel_b_seed`). So ``convert(seed=s)`` draws the
        noise that the JAX package draws on the TPU with ``PRNGKey(s)``.

        ``stages``, when given, receives :func:`convert_fn`'s intermediate
        tensors of the bucket-padded request, on the device."""
        if self.decoder is None:
            raise ValueError("this VoiceConverter was built without decoder weights")
        squeeze = np.asarray(wave).ndim == 1
        x, L = self._padded(wave)
        target = torch.as_tensor(target, dtype=torch.float32).to(self.device)
        with exact_fp32():
            out = convert_fn(self.encoder, self.decoder, x, target, float(pitch_shift),
                             kernel_b_seed(seed), self.cfg, stages=stages)
        out = out[:, :L].cpu().numpy()
        return out[0] if squeeze else out

    @torch.inference_mode()
    def convert_chunked(
        self,
        wave: np.ndarray,
        target: np.ndarray | torch.Tensor,
        pitch_shift: float = 0.0,
        seed: int = 0,
        chunk_frames: int = 512,
        halo_frames: int = 96,
        filter_halo: int = 32,
        stages: Optional[Dict[str, torch.Tensor]] = None,
    ) -> np.ndarray:
        """Chunked conversion of one utterance ``[L]`` -> ``[L]``
        (`tinyvc_tpu/infer/generator.py::VoiceConverter.convert_chunked`):
        overlap-save chunks of ``chunk_frames`` frames, each with
        ``halo_frames`` of context a side, run as one batch of ``S =
        ceil(F / chunk_frames)`` rows (`parallel/time_shard.py::
        time_batched_convert`), the wave zero-padded to ``S * chunk_frames``
        frames and the output cut to the input's length. GRN statistics,
        harmonic phase and noise phases are stitched across the chunk joins,
        so the result agrees with :meth:`convert` at the mel level. ``seed``
        means ``key=jax.random.PRNGKey(seed)``: it indexes the noise phases
        drawn per global frame. ``stages`` receives the chunk rows'
        intermediates (`time_batched_convert`)."""
        from ..parallel.time_shard import time_batched_convert

        if self.decoder is None:
            raise ValueError("this VoiceConverter was built without decoder weights")
        wave = np.asarray(wave, dtype=np.float32)
        if wave.ndim != 1:
            raise ValueError(f"chunked conversion takes one utterance [L], got {wave.shape}")
        hop = self.cfg.audio.hop_size
        L0 = wave.shape[0]
        frames = -(-L0 // hop)
        S = max(1, -(-frames // chunk_frames))
        padded = np.zeros((S * chunk_frames * hop,), np.float32)
        padded[:L0] = wave
        target = torch.as_tensor(target, dtype=torch.float32).to(self.device)
        with exact_fp32():
            out = time_batched_convert(
                self.encoder, self.decoder, torch.from_numpy(padded).to(self.device), target,
                float(pitch_shift), prng_key(seed), self.cfg, shards=S, halo_frames=halo_frames,
                filter_halo=filter_halo, stages=stages)
        return out[:L0].cpu().numpy()
