"""Whole-utterance conversion (counterpart of `tinyvc_tpu/infer/generator.py`).

``convert_fn`` is the pipeline: spectrogram -> encoder -> kNN match -> pitch
shift -> decoder (:func:`decode_infer`), with the energy estimate alongside.
``VoiceConverter`` holds the weights on one device and pads each request to
its 64-frame bucket, as the JAX package does (the padding changes the GRN
statistics, so it is part of the result).

Numerics: the JAX package's fp32 profile is exact fp32, so every
convolution and matmul here runs with TF32 off (see :func:`exact_fp32`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import TinyVCConfig
from ..dsp.energy import estimate_energy
from ..dsp.padding import autopad_waveform, pad_to_bucket
from ..dsp.pitch import shift_frequency
from ..dsp.stft import spectrogram
from ..models.decoder import Decoder
from ..models.encoder import Encoder
from ..ops.fused_filternet import filternet_fused_apply
from ..ops.retrieval import match_features
from ..utils.weights import decoder_from_jax, encoder_from_jax


@contextlib.contextmanager
def exact_fp32():
    """Run cuDNN convolutions and CUDA matmuls in full fp32 (TF32 off) for
    the duration, restoring the matmul flag afterwards. TF32 keeps ~3
    decimal digits, enough to flip kNN neighbours."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def encode_fn(encoder: Encoder, wave: torch.Tensor, cfg: TinyVCConfig):
    """wave ``[B, L]`` -> (content ``[B, F, C]``, f0 ``[B, F]``)."""
    wave = autopad_waveform(wave, cfg.audio.hop_size)
    spec = spectrogram(wave, cfg.audio.n_fft, cfg.audio.hop_size)
    return encoder.infer(spec)


def decode_infer(
    decoder: Decoder,
    content: torch.Tensor,
    f0: torch.Tensor,
    energy: torch.Tensor,
    seed: int,
    cfg: TinyVCConfig,
    noise_angle: Optional[torch.Tensor] = None,
    stages: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """``Decoder.infer`` with the U-Net picked by
    ``cfg.decoder.use_fused_filter``: "on", or "auto" on CUDA tensors, runs
    the fused U-Net (`ops/fused_filternet.py`, kernels C-F) on the packed
    source; "off", or "auto" on CPU tensors, the layer-by-layer
    :class:`FilterNet`. ``stages`` receives the source ``[B, H+2, L]``."""
    flag = cfg.decoder.use_fused_filter
    if flag not in ("auto", "on", "off"):
        raise ValueError(f"use_fused_filter must be 'auto', 'on' or 'off', got {flag!r}")
    use_fused = flag == "on" or (flag == "auto" and energy.device.type == "cuda")
    n_src = cfg.decoder.num_harmonics + 2  # harmonics + noise
    if use_fused:
        pack_width = n_src + 1 + (-(n_src + 1)) % 8
        amps, kernel = decoder.source_net(content, f0, energy)
        source = decoder.dsp(f0, amps, kernel, seed, noise_angle,
                             pack_energy=energy, pack_width=pack_width)
        out = filternet_fused_apply(decoder.filter_net, cfg.decoder, content, f0, energy, source)
    else:
        source = decoder.infer_source(content, f0, energy, seed, noise_angle)
        out = decoder.filter_net(content, f0, energy, source)
    if stages is not None:
        stages["source"] = source[:, :n_src]
    return out


def convert_fn(
    encoder: Encoder,
    decoder: Decoder,
    wave: torch.Tensor,
    target: torch.Tensor,
    pitch_shift: float,
    seed: int,
    cfg: TinyVCConfig,
    noise_angle: Optional[torch.Tensor] = None,
    stages: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """``[B, L]`` waveforms and a ``[N, C]`` (or ``[B, N, C]``) dictionary ->
    converted ``[B, L']`` with L' = L rounded up to a whole frame.

    ``seed`` seeds the hashed noise phases; ``noise_angle`` ``[B, F, bins]``
    replaces them. ``stages``, when given, receives the intermediate tensors
    (spec, content, f0, matched, energy, source) for inspection."""
    wave = autopad_waveform(wave, cfg.audio.hop_size)
    spec = spectrogram(wave, cfg.audio.n_fft, cfg.audio.hop_size)
    energy = estimate_energy(wave, cfg.audio.energy_frame_size)
    content, f0 = encoder.infer(spec)
    r = cfg.retrieval
    matched = match_features(content, target, k=r.k, alpha=r.alpha, metric=r.metric)
    f0 = shift_frequency(f0, pitch_shift)
    out = decode_infer(decoder, matched, f0, energy, seed, cfg, noise_angle, stages)
    if stages is not None:
        stages.update(spec=spec, content=content, f0=f0, matched=matched, energy=energy)
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
    (`utils/weights.py::load_npz`). The device defaults to CUDA and raises
    when CUDA is absent; the CPU runs only when asked for."""

    def __init__(
        self,
        enc_params: Mapping[str, Any],
        dec_params: Mapping[str, Any],
        cfg: TinyVCConfig | None = None,
        device: str | torch.device = "cuda",
        bucket_frames: int = 64,
    ):
        self.cfg = cfg or TinyVCConfig()
        self.device = _resolve_device(device)
        self.encoder = encoder_from_jax(enc_params, self.cfg.encoder).to(self.device)
        self.decoder = decoder_from_jax(dec_params, self.cfg.decoder, self.cfg.audio).to(self.device)
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
    ) -> np.ndarray:
        """``[B, L]`` or ``[L]`` waveform -> converted waveform of the same
        shape. ``seed`` (an int) seeds the noise phases. ``target`` is the
        ``[N, C]`` dictionary; pass it as a tensor on this converter's device
        (as :meth:`build_dictionary` returns it) to keep it from being copied
        there with every request."""
        squeeze = np.asarray(wave).ndim == 1
        x, L = self._padded(wave)
        target = torch.as_tensor(target, dtype=torch.float32).to(self.device)
        with exact_fp32():
            out = convert_fn(self.encoder, self.decoder, x, target, float(pitch_shift),
                             int(seed), self.cfg)
        out = out[:, :L].cpu().numpy()
        return out[0] if squeeze else out
