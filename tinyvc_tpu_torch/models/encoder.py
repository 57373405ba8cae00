"""Content encoder and pitch classifier (counterpart of
`tinyvc_tpu/models/encoder.py`). Layout ``[B, T, C]``: spectrogram frames in,
768-dim content features and f0 out. Both stacks compute in
``cfg.compute_dtype`` and return it, as JAX's do: under "bfloat16" the
content features and the logits are bf16 (``serving_config()`` keeps the
encoder in fp32, because bf16 content flips kNN neighbours)."""

from __future__ import annotations

import torch
from torch import nn

from ..config import AudioConfig, EncoderConfig
from ..ops.retrieval import top_k_small
from .layers import ConvNeXtStack, compute_dtype


def freq2id(f: torch.Tensor, num_classes: int = 512, classes_per_octave: int = 48,
            min_frequency: float = 20.0) -> torch.Tensor:
    """Hz -> log-spaced pitch class ids, ``ceil(clamp(cpo * log2(f / fmin),
    0, nc - 1))`` as int64; f0 = 0 (unvoiced) gives ``log2(0) = -inf``,
    clamped to class 0."""
    x = classes_per_octave * torch.log2(f / min_frequency)
    return torch.ceil(x.clamp(0.0, num_classes - 1)).long()


def id2freq(ids: torch.Tensor, classes_per_octave: int = 48, min_frequency: float = 20.0) -> torch.Tensor:
    """Pitch class ids -> Hz; frequencies <= fmin map to 0."""
    f = min_frequency * torch.pow(2.0, ids.float() / classes_per_octave)
    return torch.where(f <= min_frequency, torch.zeros_like(f), f)


def decode_f0(logits: torch.Tensor, k: int = 4, classes_per_octave: int = 48,
              min_frequency: float = 20.0) -> torch.Tensor:
    """Softmax-weighted mean of the top-k class frequencies:
    logits ``[B, T, classes]`` -> f0 ``[B, T]``."""
    vals, idx = top_k_small(logits, k)
    probs = torch.softmax(vals, dim=-1)
    f0 = torch.sum(probs * id2freq(idx, classes_per_octave, min_frequency), dim=-1)
    return torch.where(f0 <= min_frequency, torch.zeros_like(f0), f0)


class PitchEstimator(nn.Module):
    """Spectrogram ``[B, T, bins]`` -> pitch-class logits."""

    def __init__(self, cfg: EncoderConfig, in_features: int):
        super().__init__()
        self.stack = ConvNeXtStack(
            in_features, cfg.pitch_channels, cfg.num_pitch_classes, (1,) * cfg.pitch_num_layers,
            dtype=compute_dtype(cfg.compute_dtype))

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        return self.stack(spec)


class SSLFeatureEstimator(nn.Module):
    """Spectrogram ``[B, T, bins]`` -> content features."""

    def __init__(self, cfg: EncoderConfig, in_features: int):
        super().__init__()
        self.stack = ConvNeXtStack(in_features, cfg.ssl_channels, cfg.ssl_dim, cfg.ssl_dilations,
                                   dtype=compute_dtype(cfg.compute_dtype))

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        return self.stack(spec)


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig = EncoderConfig(), audio: AudioConfig = AudioConfig()):
        super().__init__()
        self.cfg = cfg
        self.ssl_feature_estimator = SSLFeatureEstimator(cfg, audio.fft_bin)
        self.pitch_estimator = PitchEstimator(cfg, audio.fft_bin)

    def forward(self, spec: torch.Tensor):
        """-> (content ``[B, T, ssl_dim]``, pitch logits)."""
        return self.ssl_feature_estimator(spec), self.pitch_estimator(spec)

    def infer(self, spec: torch.Tensor):
        """-> (content ``[B, T, ssl_dim]``, f0 ``[B, T]``)."""
        content, logits = self(spec)
        f0 = decode_f0(logits, self.cfg.pitch_topk, self.cfg.classes_per_octave,
                       self.cfg.min_frequency)
        return content, f0
