"""Typed configuration of the conversion path.

Counterpart of `tinyvc_tpu/config.py`: the same dataclasses with the same
defaults, copied rather than imported so that this package never reads the
JAX package. Only the fields the conversion paths (whole-utterance and
streaming) and the decoder's training read are kept; most TPU lowering
switches (``use_pallas``, ``conv_impl``, ...) have no counterpart here,
because this package picks its kernels from the device of the tensors it is
given.

``compute_dtype`` ("float32" | "bfloat16") keeps the JAX package's meaning;
:func:`serving_config` runs the decoder in bf16 and keeps the encoder, and
so the kNN feature space, in fp32. ``AudioConfig.spectrogram_impl`` and
``RetrievalConfig.impl`` keep the JAX spellings, so one config dict reads
the same in both packages: "pallas" means the hand-written spectrogram
kernel G here (`kernels/spectrogram.py`), and "auto" picks it, and the kNN
kernel H, by the JAX package's gates (`infer/generator.py`).

``DecoderConfig.use_fused_filter`` keeps the JAX package's meaning:
"auto" runs the fused U-Net (`ops/fused_filternet.py`, kernels C-F) when the
decoder's tensors lie on CUDA and the layer-by-layer U-Net
(`models/decoder.py::FilterNet`) on the CPU, as `_on_cpu_backend()` picks
for JAX; "on" and "off" force one or the other on either device.
``DecoderConfig.use_fused_filter_train`` is the same switch for the GAN
training step (`train/decoder_train.py`): "auto" trains the differentiable
fused U-Net (kernels C-F forward, I-L backward) on CUDA tensors and the
layer-by-layer U-Net on the CPU, as JAX picks on a TPU and on its CPU
backend; "on" trains the fused U-Net on either device (on the CPU through
the kernels' plain versions, as JAX runs its kernels in interpret mode),
"off" the layer-by-layer one.

``TrainConfig``, ``MelConfig`` and ``DiscriminatorConfig`` are
`tinyvc_tpu/config.py`'s, field for field. ``mrd_conv_impl`` keeps the JAX
spellings: "fused" runs the phase-plane MRD chain (`ops/mrd_planes.py`,
kernels M, N and O on CUDA tensors); "lax", "hybrid", "nhwc", "unfold" and
"xres" are the TPU's layout lowerings of one function, and the port runs
each of them as its NCHW ``F.conv2d`` form (`models/discriminator.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 24000
    n_fft: int = 1920
    hop_size: int = 480  # 20 ms -> 50 frames/s
    energy_frame_size: int = 64
    spectrogram_impl: str = "auto"  # 'auto' | 'pallas' (kernel G) | 'xla' (torch.fft)

    @property
    def fft_bin(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    pitch_channels: int = 128
    pitch_num_layers: int = 4
    num_pitch_classes: int = 512
    classes_per_octave: int = 48
    min_frequency: float = 20.0
    pitch_topk: int = 4
    ssl_channels: int = 384
    ssl_dilations: Tuple[int, ...] = (1, 3, 9, 1, 1, 1)
    ssl_dim: int = 768
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    num_harmonics: int = 14  # plus fundamental -> 15 sines
    source_channels: int = 128
    source_kernel_size: int = 7
    source_num_layers: int = 3
    filter_channels: Tuple[int, ...] = (384, 192, 96, 48, 24)
    filter_factors: Tuple[int, ...] = (2, 3, 4, 4, 5)
    content_channels: int = 768
    use_fused_filter: str = "auto"  # 'auto' | 'on' | 'off'
    use_fused_filter_train: str = "auto"  # 'auto' | 'on' | 'off'
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # recompute the layer-by-layer U-Net's Downsample and Upsample blocks in
    # the backward instead of keeping their activations (JAX's nn.remat);
    # the fused training U-Net does not read it, as in JAX
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    k: int = 4
    alpha: float = 0.0
    metric: str = "cos"  # 'cos' | 'IP' | 'L2'
    impl: str = "auto"  # 'auto' (kernel H where its gate holds) | 'xla' (ops/retrieval.py)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    learning_rate: float = 1e-4
    adam_betas_gan: Tuple[float, float] = (0.8, 0.99)
    grad_clip: float = 1.0
    # decoder GAN schedule
    max_steps: int = 300000
    discriminator_join: int = 100000
    weight_adv: float = 2.0
    weight_dsp: float = 1.0
    weight_spec: float = 1.0
    weight_feat: float = 2.0
    # encoder distillation
    encoder_epochs: int = 60
    distill_weight: float = 45.0
    unvoiced_class_weight: float = 5e-3
    # data
    chunk_length: int = 48000  # 2 s at 24 kHz
    # logging / checkpoints
    log_interval: int = 50
    save_interval: int = 500
    # GAN crop fed to the discriminators
    disc_crop: int = 8000


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming SOLA conversion (`tinyvc_tpu/config.py:175-193`): each block
    of ``block_size`` samples re-converts a window of :attr:`input_size`."""

    block_size: int = 1920
    extra_size: int = 3840
    sola_search_size: int = 1920
    crossfade_size: int = 1920
    last_delay_size: int = 3840
    use_phase_vocoder: bool = False

    @property
    def input_size(self) -> int:
        return max(
            self.block_size + self.crossfade_size + self.sola_search_size
            + 2 * self.last_delay_size,
            self.block_size + self.extra_size,
        )


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """The log-mel loss's spectrogram (``-spec-type mel``)."""

    sample_rate: int = 24000
    n_fft: int = 1024
    hop_size: int = 256
    n_mels: int = 80


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """MPD + MRD (`tinyvc_tpu/config.py:99-126`)."""

    periods: Tuple[int, ...] = (1, 2, 3, 5, 7, 11)
    resolutions: Tuple[int, ...] = (32, 64, 128, 256)
    channels: int = 32
    max_channels: int = 256
    num_layers: int = 4
    # False keeps the reference's dropped MRD activation (its leaky ReLU is
    # computed and discarded), so the MRD chain is linear
    mrd_fixed_activation: bool = False
    compute_dtype: str = "float32"  # the convs' operands; params stay fp32
    mrd_conv_impl: str = "lax"  # 'lax' | 'hybrid' | 'nhwc' | 'unfold' | 'xres' | 'fused'


@dataclasses.dataclass(frozen=True)
class TinyVCConfig:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    retrieval: RetrievalConfig = dataclasses.field(default_factory=RetrievalConfig)
    discriminator: DiscriminatorConfig = dataclasses.field(default_factory=DiscriminatorConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)


def serving_config() -> TinyVCConfig:
    """The recommended inference profile (`tinyvc_tpu/config.py:252-258`):
    the encoder, and so the kNN feature space, in fp32; the decoder's
    SourceNet and U-Net in bf16."""
    return TinyVCConfig(decoder=DecoderConfig(compute_dtype="bfloat16"))
