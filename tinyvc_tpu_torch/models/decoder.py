"""Source-filter DDSP vocoder (counterpart of `tinyvc_tpu/models/decoder.py`):
SourceNet -> harmonic and noise source -> FilterNet U-Net.

The DSP stage runs kernels A and B (`kernels/oscillator.py`,
`kernels/noise.py`) on CUDA tensors and their plain versions on CPU tensors;
the JAX module's ``oscillate_harmonics`` and ``oscillate_noise`` are those
plain versions, in `dsp/synth.py`.
:class:`FilterNet` is the U-Net layer by layer, channels-first: the JAX
package's ``use_fused_filter="off"`` path, which the CPU takes by default.
The fused U-Net of the serving path, which CUDA takes by default, is
`ops/fused_filternet.py::filternet_fused_apply` over the same parameters
(`infer/generator.py::decode_infer` picks one).

Training (`train/decoder_train.py`): :meth:`Decoder.dsp_train` builds the
source with the differentiable oscillator bank (`kernels/oscillator.py::
OscillatorBank`: kernels A and I on CUDA, their plain versions on the CPU)
and the noise in the JAX package's XLA form, :func:`oscillate_noise` with
phases drawn from the step's key (kernel B has no gradient, and the JAX
package keeps it off this path); :meth:`Decoder.train_forward` runs the
layer-by-layer U-Net, and the training step runs the fused one
(`ops/fused_filternet.py::filternet_fused_train`) where
``use_fused_filter_train`` picks it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import AudioConfig, DecoderConfig
from ..dsp.interp import downsample_time_int_t, upsample_time_int_t
from ..dsp.synth import oscillate_noise
from ..kernels.noise import oscillate_noise_hashed
from ..kernels.oscillator import OscillatorBank, oscillator_bank
from .layers import Conv1d, ConvNeXtLayer, Dense, Dense1x1CF, FiLM, compute_dtype


def _log_f0_feature(f0: torch.Tensor) -> torch.Tensor:
    """``log(relu(f0) + 1e-6)[..., None]``."""
    return torch.log(f0.clamp_min(0.0) + 1e-6)[..., None]


class SourceNet(nn.Module):
    """Per-harmonic amplitudes and the noise magnitude filter. The input
    denses and the ConvNeXt layers compute in ``cfg.compute_dtype``; the
    heads run in fp32 on the fp32 cast of their input, as they feed the DSP
    (`tinyvc_tpu/models/decoder.py:137-166`)."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), audio: AudioConfig = AudioConfig()):
        super().__init__()
        self.hop = audio.hop_size
        ch = cfg.source_channels
        dt = compute_dtype(cfg.compute_dtype)
        self.content_in = Dense(cfg.content_channels, ch, dt)
        self.energy_in = Dense(1, ch, dt)
        self.f0_in = Dense(1, ch, dt)
        for i in range(cfg.source_num_layers):
            self.add_module(f"layer_{i}", ConvNeXtLayer(ch, cfg.source_kernel_size, dtype=dt))
        self.num_layers = cfg.source_num_layers
        self.to_amps = Dense(ch, cfg.num_harmonics + 1)
        self.to_kernel = Dense(ch, audio.fft_bin)

    def forward(self, content: torch.Tensor, f0: torch.Tensor,
                energy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """content ``[B,F,C]``, f0 ``[B,F]``, energy ``[B,L]`` ->
        (amps ``[B,F,H+1]``, kernel ``[B,F,fft_bin]``)."""
        B, L = energy.shape
        energy_f = energy.reshape(B, L // self.hop, self.hop).amax(dim=-1)
        x = (self.content_in(content) + self.energy_in(energy_f[..., None])
             + self.f0_in(_log_f0_feature(f0)))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        x = x.float()
        amps = F.elu(self.to_amps(x)) + 1.0
        kernel = F.elu(self.to_kernel(x)) + 1.0
        return amps, kernel


class Downsample(nn.Module):
    """Linear downsample + residual dilated conv stack, channels-first, in
    ``dtype``."""

    def __init__(self, in_features: int, out_features: int, factor: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.factor = factor
        self.down_res = Dense1x1CF(in_features, out_features, dtype)
        self.c1 = Conv1d(in_features, in_features, 3, dilation=1, dtype=dtype)
        self.c2 = Conv1d(in_features, in_features, 3, dilation=2, dtype=dtype)
        self.c3 = Conv1d(in_features, out_features, 3, dilation=4, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(downsample_time_int_t(x, self.factor))

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """Everything after the decimation."""
        res = self.down_res(x)
        x = self.c1(F.leaky_relu(x, 0.1))
        x = self.c2(F.leaky_relu(x, 0.1))
        x = self.c3(F.leaky_relu(x, 0.1))
        return x + res


class Upsample(nn.Module):
    """Linear upsample + two FiLM-conditioned residual groups, channels-first,
    in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, factor: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.factor = factor
        self.c1 = Conv1d(in_features, in_features, 3, dilation=1, dtype=dtype)
        self.c2 = Conv1d(in_features, in_features, 3, dilation=3, dtype=dtype)
        self.film1 = FiLM(in_features, in_features, dtype)
        self.c3 = Conv1d(in_features, in_features, 3, dilation=9, dtype=dtype)
        self.c4 = Conv1d(in_features, in_features, 3, dilation=27, dtype=dtype)
        self.film2 = FiLM(in_features, in_features, dtype)
        self.c5 = Dense1x1CF(in_features, out_features, dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return self.body(upsample_time_int_t(x, self.factor), cond)

    def body(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """Everything after the interpolation."""
        res = x
        x = self.c1(F.leaky_relu(x, 0.1))
        x = self.c2(F.leaky_relu(x, 0.1))
        x = self.film1(x, cond) + res
        res = x
        x = self.c3(F.leaky_relu(x, 0.1))
        x = self.c4(F.leaky_relu(x, 0.1))
        x = self.film2(x, cond) + res
        return self.c5(x)


class FilterNet(nn.Module):
    """Sample-rate U-Net refining the DSP source into the waveform. The down
    path takes cat(source, energy); its outputs FiLM-condition the up path.
    Everything but the output conv computes in ``cfg.compute_dtype``; the
    output conv is fp32 (`tinyvc_tpu/models/decoder.py::FilterNet`). With
    ``cfg.remat``, each Downsample and Upsample call under grad keeps only
    its inputs and recomputes its activations in the backward
    (``torch.utils.checkpoint``, JAX's ``nn.remat`` of both blocks)."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig()):
        super().__init__()
        channels = list(cfg.filter_channels)
        factors = list(cfg.filter_factors)
        dt = compute_dtype(cfg.compute_dtype)
        self.content_in = Dense(cfg.content_channels, channels[0], dt)
        self.f0_in = Dense(1, channels[0], dt)
        n_src = cfg.num_harmonics + 3  # harmonics, noise, energy
        self.down_0 = Conv1d(n_src, channels[-1], 3, dtype=dt)
        cs = list(reversed(channels[1:]))
        ns = cs[1:] + [channels[0]]
        for i, (c, n, f) in enumerate(zip(cs, ns, reversed(factors[1:]))):
            self.add_module(f"down_{i + 1}", Downsample(c, n, f, dt))
        self.num_down = len(ns)
        ns_up = channels[1:] + [channels[-1]]
        for i, (c, n, f) in enumerate(zip(channels, ns_up, factors)):
            self.add_module(f"up_{i}", Upsample(c, n, f, dt))
        self.num_up = len(factors)
        self.output_layer = Conv1d(channels[-1], 1, 7)
        self.remat = cfg.remat

    def _block(self, name: str, *args: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, content: torch.Tensor, f0: torch.Tensor, energy: torch.Tensor,
                source: torch.Tensor) -> torch.Tensor:
        """content ``[B,F,C]``, f0 ``[B,F]``, energy ``[B,L]``, source
        ``[B,H+2,L]`` -> waveform ``[B,L]``."""
        x = (self.content_in(content) + self.f0_in(_log_f0_feature(f0))).transpose(1, 2)
        src = self.down_0(torch.cat([source, energy[:, None, :]], dim=1))
        skips = [src]
        for i in range(self.num_down):
            src = self._block(f"down_{i + 1}", src)
            skips.append(src)
        for i in range(self.num_up):
            x = self._block(f"up_{i}", x, skips[len(skips) - 1 - i])
        return self.output_layer(x)[:, 0, :]


def fused_pack_width(n_src: int) -> int:
    """Rows of the fused stem's packed input for ``n_src`` source rows: the
    source, the energy row, and zero rows up to a multiple of 8
    (`tinyvc_tpu/models/decoder.py:439-446`)."""
    return n_src + 1 + (-(n_src + 1)) % 8


def pack_source(harmonics: torch.Tensor, noise: torch.Tensor,
                energy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Harmonics ``[B, H+1, L]`` and noise ``[B, L]`` -> the source ``[B,
    H+2, L]``; with ``energy`` ``[B, L]``, the energy row and zero rows up
    to :func:`fused_pack_width` rows follow: the fused stem's input."""
    parts = [harmonics, noise[:, None, :]]
    if energy is not None:
        B, n_src, L = harmonics.shape[0], harmonics.shape[1] + 1, harmonics.shape[2]
        parts.append(energy[:, None, :].to(harmonics.dtype))
        npad = fused_pack_width(n_src) - n_src - 1
        if npad:
            parts.append(harmonics.new_zeros((B, npad, L)))
    return torch.cat(parts, dim=1)


class Decoder(nn.Module):
    """SourceNet -> DSP -> FilterNet."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), audio: AudioConfig = AudioConfig()):
        super().__init__()
        self.audio = audio
        self.source_net = SourceNet(cfg, audio)
        self.filter_net = FilterNet(cfg)

    def dsp_parts(self, f0: torch.Tensor, amps: torch.Tensor, kernel: torch.Tensor, seed: int,
                  noise_angle: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Harmonics times amplitudes (kernel A) ``[B, H+1, L]`` and
        filtered noise (kernel B) ``[B, L]``, fp32. The noise phases are
        ``noise_angle`` when given, else hashed from ``seed``."""
        a = self.audio
        harmonics = oscillator_bank(f0.contiguous(), amps.contiguous(), a.hop_size, a.sample_rate)
        noise = oscillate_noise_hashed(
            kernel.contiguous(), seed, a.hop_size, a.n_fft,
            angle=None if noise_angle is None else noise_angle.contiguous(),
        )
        return harmonics, noise

    def dsp(self, f0: torch.Tensor, amps: torch.Tensor, kernel: torch.Tensor, seed: int,
            noise_angle: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`dsp_parts` as the source ``[B, H+2, L]``, channels-first."""
        return pack_source(*self.dsp_parts(f0, amps, kernel, seed, noise_angle))

    def dsp_train(self, f0: torch.Tensor, amps: torch.Tensor, kernel: torch.Tensor,
                  noise_angle: torch.Tensor) -> torch.Tensor:
        """The training step's source ``[B, H+2, L]`` (fp32,
        channels-first), differentiable in ``amps`` and ``kernel``: the
        oscillator bank through :class:`OscillatorBank` (no gradient for
        f0, the JAX package's ``grad_f0=False``) and the noise with the
        phases ``noise_angle`` ``[B, F, fft_bin]``
        (`tinyvc_tpu/models/decoder.py::Decoder.dsp`, its training call)."""
        a = self.audio
        harmonics = OscillatorBank.apply(f0, amps, a.hop_size, a.sample_rate, 20.0)
        noise = oscillate_noise(kernel, noise_angle, a.hop_size, a.n_fft)
        return torch.cat([harmonics, noise[:, None, :]], dim=1)

    def train_forward(self, content: torch.Tensor, f0: torch.Tensor, energy: torch.Tensor,
                      noise_angle: torch.Tensor):
        """(waveform ``[B, L]``, source ``[B, H+2, L]``) through the
        layer-by-layer U-Net; the source feeds the DSP loss
        (`tinyvc_tpu/models/decoder.py::Decoder.train_forward`)."""
        amps, kernel = self.source_net(content, f0, energy)
        source = self.dsp_train(f0, amps, kernel, noise_angle)
        return self.filter_net(content, f0, energy, source), source

    def infer(self, content: torch.Tensor, f0: torch.Tensor, energy: torch.Tensor,
              seed: int, noise_angle: Optional[torch.Tensor] = None) -> torch.Tensor:
        """content ``[B,F,C]``, f0 ``[B,F]``, energy ``[B,L]`` -> waveform
        ``[B, L]``."""
        source = self.infer_source(content, f0, energy, seed, noise_angle)
        return self.filter_net(content, f0, energy, source)

    def infer_source(self, content: torch.Tensor, f0: torch.Tensor, energy: torch.Tensor,
                     seed: int, noise_angle: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The DSP source ``[B, H+2, L]`` that :meth:`infer` filters."""
        amps, kernel = self.source_net(content, f0, energy)
        return self.dsp(f0, amps, kernel, seed, noise_angle)
