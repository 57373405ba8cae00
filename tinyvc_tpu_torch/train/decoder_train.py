"""The decoder's GAN training step, before and after the discriminator
joins (counterpart of `tinyvc_tpu/train/decoder_train.py`).

The pre-join step (:class:`TrainStep`, ``d_join=False``): split the key
into the gain's and the noise's (`utils/prng.py`, JAX's own numbers); scale
each row of the wave by ``2 * uniform``; the spectrogram, the frozen encoder, the self-kNN match
(no gradient) and the energy; SourceNet, the DSP source
(`models/decoder.py::Decoder.dsp_train`) and the U-Net: the fused one
(`ops/fused_filternet.py::filternet_fused_train`, kernels A and C-F
forward, I-L backward) when ``cfg.decoder.use_fused_filter_train`` is "on",
or "auto" on CUDA tensors, else the layer-by-layer one; the losses
``loss_spec`` (of the waveform) and ``loss_dsp`` (of the summed source)
against the wave; then the update.

Each network's update is optax's ``skip_if_nonfinite(chain(
clip_by_global_norm(1.0), adamw(lr, b1=0.8, b2=0.99)))`` written out: the global norm without
``clip_grad_norm_``'s ``+1e-6``, AdamW with optax's defaults (eps 1e-8,
weight decay 1e-4), and a step whose gradient norm is not finite skipped
whole: parameters, moments and Adam's count untouched, the skip counted.

After ``discriminator_join`` the step is the post-join one
(:class:`PostJoinStep`, `tinyvc_tpu/train/decoder_train.py:358-443`): both discriminator
forwards run once, on the augmented wave's centre crop and on the fake's;
the generator's loss adds ``weight_adv`` times the LSGAN loss of the fake
logits and ``weight_feat`` times the feature-matching loss (the real
features held constant), and its gradients are taken with respect to the
generator only; the discriminator's LSGAN loss on both logits gives its
gradients with respect to the discriminator only. Both gradients come from
the same forwards, before either update. Under CUDA the step runs with TF32
off (`infer/generator.py::exact_fp32`), the JAX package's fp32 numerics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import TinyVCConfig
from ..dsp.energy import estimate_energy
from ..dsp.stft import spectrogram
from ..infer.generator import _resolve_device, exact_fp32
from ..models.decoder import Decoder
from ..models.discriminator import Discriminator, fused_mrd_valid_counts
from ..models.encoder import Encoder
from ..ops.fused_filternet import filternet_fused_train
from ..ops.retrieval import match_features
from ..parallel.mesh import data_mean, global_rows
from ..utils import prng
from .losses import (discriminator_adversarial_loss, feature_matching_loss,
                     generator_adversarial_loss, log_mel_loss, multi_scale_stft_loss)

ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4  # optax.adamw's default


@dataclasses.dataclass
class OptState:
    """One optimizer's state: AdamW's moments by parameter name, Adam's
    count and the count of skipped steps."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0
    notfinite_count: int = 0

    @classmethod
    def fresh(cls, module: torch.nn.Module) -> "OptState":
        params = dict(module.named_parameters())
        return cls({k: torch.zeros_like(p) for k, p in params.items()},
                   {k: torch.zeros_like(p) for k, p in params.items()})


@dataclasses.dataclass
class TrainState:
    """The GAN's train state (`GanTrainState`): the decoder and the
    discriminator (their parameters), each network's optimizer state, and
    the step. The pre-join step reads no discriminator, so a state without
    one (None) serves it."""

    decoder: Decoder
    gen_opt: OptState
    discriminator: Optional[Discriminator] = None
    disc_opt: Optional[OptState] = None
    step: int = 0

    @classmethod
    def fresh(cls, decoder: Decoder,
              discriminator: Optional[Discriminator] = None) -> "TrainState":
        return cls(decoder, OptState.fresh(decoder), discriminator,
                   None if discriminator is None else OptState.fresh(discriminator))


def init_params(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw ``module``'s parameters from flax's initializers as
    `tinyvc_tpu/models/layers.py` declares them: every kernel
    U(+-1/sqrt(fan_in)) (``variance_scaling(1/3, "fan_in", "uniform")``),
    every bias U(+-1/sqrt(fan_in)) of its kernel, LayerNorm's gain 1 and
    shift 0, GRN's gain and shift 0; a weight-normalised conv's ``v``
U(+-1/sqrt(kh*kw*cin)), its ``g`` the norm of ``v`` per output channel and
its bias U(+-1/sqrt(kh*kw*cin)) (`tinyvc_tpu/models/discriminator.py:97-114`). Drawn
on the CPU from ``generator``."""
    with torch.no_grad():
        for sub in module.modules():
            weight = getattr(sub, "weight", None)
            if isinstance(weight, torch.nn.Parameter):
                fan_in = int(np.prod(weight.shape[1:]))
                bound = 1.0 / math.sqrt(fan_in)
                for p in (weight, sub.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
            elif isinstance(getattr(sub, "v", None), torch.nn.Parameter):
                bound = 1.0 / math.sqrt(int(np.prod(sub.v.shape[:3])))
                sub.v.copy_(torch.empty(sub.v.shape).uniform_(-bound, bound, generator=generator))
                sub.g.copy_(torch.sqrt(torch.sum(sub.v * sub.v, dim=(0, 1, 2))))
                sub.bias.copy_(torch.empty(sub.bias.shape).uniform_(-bound, bound,
                                                                    generator=generator))
            elif hasattr(sub, "gamma"):
                is_layer_norm = type(sub).__name__ == "ChannelLayerNorm"
                sub.gamma.fill_(1.0 if is_layer_norm else 0.0)
                sub.beta.zero_()


def init_state(cfg: TinyVCConfig, seed: int, device="cuda") -> TrainState:
    """A fresh train state: the decoder, then the discriminator, drawn by
    :func:`init_params` from ``torch.Generator().manual_seed(seed)``; zero
    moments. On CUDA unless ``device`` asks for the CPU (it raises without
    a card)."""
    device = _resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    dec = Decoder(cfg.decoder, cfg.audio)
    init_params(dec, generator)
    disc = Discriminator(cfg.discriminator)
    init_params(disc, generator)
    return TrainState.fresh(dec.train().to(device), disc.train().to(device))


def use_fused_train(cfg: TinyVCConfig, device: torch.device) -> bool:
    """``use_fused_filter_train``: "on", or "auto" on CUDA (JAX's TPU
    choice; on the CPU "auto" is the layer-by-layer U-Net, as for JAX)."""
    flag = cfg.decoder.use_fused_filter_train
    if flag not in ("auto", "on", "off"):
        raise ValueError(f"use_fused_filter_train must be 'auto', 'on' or 'off', got {flag!r}")
    return flag == "on" or (flag == "auto" and torch.device(device).type == "cuda")


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def apply_update(opt: OptState, module: torch.nn.Module, grads: Dict[str, torch.Tensor],
                 cfg: TinyVCConfig, betas: Optional[Tuple[float, float]] = None,
                 skip_nonfinite: bool = True) -> bool:
    """The optimizer step on ``module``'s parameters and ``opt`` in place:
    ``clip_by_global_norm(cfg.train.grad_clip)``, then AdamW at
    ``cfg.train.learning_rate`` with ``betas`` (default the GAN's
    ``adam_betas_gan``). With ``skip_nonfinite`` (optax's
    ``skip_if_nonfinite``), a step whose gradients' global norm is not
    finite is skipped and counted, and False returned. The generator and the
    discriminator each take it with their own state
    (`tinyvc_tpu/train/decoder_train.py:97-110`: one transform, two
    instances); the encoder takes it with optax's default betas and no skip
    (`tinyvc_tpu/train/encoder_train.py:38-42`)."""
    params = dict(module.named_parameters())
    gnorm = _global_norm(grads.values())
    if skip_nonfinite and not bool(torch.isfinite(gnorm)):
        opt.notfinite_count += 1
        return False
    tc = cfg.train
    b1, b2 = tc.adam_betas_gan if betas is None else betas
    within = gnorm < tc.grad_clip
    opt.count = min(opt.count + 1, 2**31 - 1)
    # Adam's bias corrections in fp32, as optax computes them, carried to
    # the device without a wait (a Python number would be divided by its
    # reciprocal on CUDA)
    c1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** opt.count).to(
        gnorm.device, non_blocking=True)
    c2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** opt.count).to(
        gnorm.device, non_blocking=True)
    with torch.no_grad():
        for name, p in params.items():
            g = torch.where(within, grads[name], (grads[name] / gnorm) * tc.grad_clip)
            mu = (1 - b1) * g + b1 * opt.mu[name]
            nu = (1 - b2) * (g * g) + b2 * opt.nu[name]
            u = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
            u = (u + WEIGHT_DECAY * p) * (-tc.learning_rate)
            p.add_(u)
            opt.mu[name], opt.nu[name] = mu, nu
    return True


def _grads(loss: torch.Tensor, module: torch.nn.Module, retain_graph: bool = False):
    """d loss / d every parameter of ``module``, by name (zeros where the
    loss does not reach)."""
    params = dict(module.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                retain_graph=retain_graph)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}


class TrainStep:
    """The pre-join step of `make_train_step`. ``loss_and_grads`` runs the
    forward and backward and returns (loss_g, metrics, gradients by
    parameter name) without touching the state; calling the step also
    applies the update and returns the metrics, with ``loss_g`` and
    ``skipped_g``.

    With ``mesh`` (`parallel/mesh.py::Mesh`) the step is data-parallel:
    ``wave`` is this rank's rows of the global batch, the random draws
    cover the global batch (each rank keeps its rows, so the ranks together
    draw what one process draws), and the gradients and losses are averaged
    over the data group before the global norm and the non-finite skip, so
    that every rank takes the same update."""

    def __init__(self, cfg: TinyVCConfig, spec_loss_type: str = "ms-stft",
                 dtype_name: Optional[str] = None, mesh=None):
        if spec_loss_type == "ms-stft":
            self.spec_loss = multi_scale_stft_loss
        elif spec_loss_type == "mel":
            m = cfg.mel
            self.spec_loss = lambda x, y: log_mel_loss(x, y, m.sample_rate, m.n_fft,
                                                       m.hop_size, m.n_mels)
        else:
            raise ValueError(f"spec_loss_type must be 'ms-stft' or 'mel', got {spec_loss_type!r}")
        self.cfg = cfg
        self.dtype_name = dtype_name
        self.mesh = mesh

    def operands(self, device: torch.device) -> str:
        """The fused kernels' operand dtype (the U-Net's, and the fused
        MRD's): ``dtype_name`` when given, else bf16 on CUDA (the TPU's
        choice, `tinyvc_tpu/train/decoder_train.py:231`,
        `tinyvc_tpu/models/discriminator.py:352-356`) and fp32 on the CPU (JAX's
        interpret runs)."""
        if self.dtype_name is not None:
            return self.dtype_name
        return "bfloat16" if torch.device(device).type == "cuda" else "float32"

    def forward_fake(self, decoder: Decoder, encoder: Encoder, wave: torch.Tensor,
                     noise_angle: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(fake waveform ``[B, L]``, DSP source ``[B, H+2, L]``)."""
        cfg = self.cfg
        with torch.no_grad():
            spec = spectrogram(wave, cfg.audio.n_fft, cfg.audio.hop_size)
            content, f0 = encoder.infer(spec)
            z_fake = match_features(content, content, k=cfg.retrieval.k,
                                    metric=cfg.retrieval.metric)
            energy = estimate_energy(wave, cfg.audio.energy_frame_size)
        if not use_fused_train(cfg, wave.device):
            return decoder.train_forward(z_fake, f0, energy, noise_angle)
        amps, kernel = decoder.source_net(z_fake, f0, energy)
        source = decoder.dsp_train(f0, amps, kernel, noise_angle)
        fake = filternet_fused_train(decoder.filter_net, cfg.decoder, z_fake, f0, energy, source,
                                     self.operands(wave.device))
        return fake, source

    def augment(self, wave: torch.Tensor, key: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step's key split into the gain's and the noise's: (the wave
        scaled by ``2 * uniform`` per row, the noise phases), this rank's
        rows of the global batch's draws."""
        cfg = self.cfg
        k_gain, k_noise = prng.split(np.asarray(key, np.uint32))
        B, L = wave.shape
        Bg, rows = global_rows(self.mesh, B)
        F_ = L // cfg.audio.hop_size
        gain = torch.from_numpy(prng.uniform(k_gain, (Bg, 1), rows=rows)).to(wave.device)
        angle = torch.from_numpy(prng.uniform(k_noise, (Bg, F_, cfg.audio.fft_bin), -math.pi,
                                              math.pi, rows=rows)).to(wave.device)
        return wave.float() * (gain * 2.0), angle

    def spec_losses(self, fake: torch.Tensor, source: torch.Tensor, wave: torch.Tensor):
        """(loss_spec, loss_dsp) of the waveform and of the summed source."""
        return self.spec_loss(fake, wave), self.spec_loss(source.sum(dim=1), wave)

    def loss_and_grads(self, state: TrainState, encoder: Encoder, wave: torch.Tensor,
                       key: np.ndarray):
        cfg = self.cfg
        wave, angle = self.augment(wave, key)
        with exact_fp32(), torch.enable_grad():
            fake, source = self.forward_fake(state.decoder, encoder, wave, angle)
            loss_spec, loss_dsp = self.spec_losses(fake, source, wave)
            loss_g = loss_spec * cfg.train.weight_spec + loss_dsp * cfg.train.weight_dsp
            grads = _grads(loss_g, state.decoder)
        metrics = {"loss_spec": loss_spec.detach(), "loss_dsp": loss_dsp.detach(),
                   "loss_g": loss_g.detach()}
        grads, metrics = data_mean(self.mesh, grads, metrics)
        return metrics.pop("loss_g"), metrics, grads

    def __call__(self, state: TrainState, encoder: Encoder, wave: torch.Tensor,
                 key: np.ndarray) -> Dict[str, torch.Tensor]:
        loss_g, metrics, grads = self.loss_and_grads(state, encoder, wave, key)
        with exact_fp32():
            apply_update(state.gen_opt, state.decoder, grads, self.cfg)
        state.step += 1
        metrics["loss_g"] = loss_g
        metrics["skipped_g"] = state.gen_opt.notfinite_count
        return metrics


class PostJoinStep(TrainStep):
    """The post-join step of `make_train_step`.
    ``loss_and_grads`` returns (loss_g, metrics, the generator's gradients,
    the discriminator's gradients) without touching the state; calling the
    step applies both updates, each network with its own optimizer state,
    and returns the metrics ``loss_spec``, ``loss_dsp``, ``loss_adv``,
    ``loss_feat``, ``loss_g``, ``loss_d``, ``skipped_g`` and ``skipped_d``."""

    def __init__(self, cfg: TinyVCConfig, spec_loss_type: str = "ms-stft",
                 dtype_name: Optional[str] = None, mesh=None):
        super().__init__(cfg, spec_loss_type, dtype_name, mesh)
        # the fused MRD's plane-major maps: the losses divide by the valid counts
        if cfg.discriminator.mrd_conv_impl == "fused":
            self.logit_counts, self.fmap_counts = fused_mrd_valid_counts(
                cfg.discriminator, cfg.train.disc_crop)
        else:
            self.logit_counts = self.fmap_counts = None

    def loss_and_grads(self, state: TrainState, encoder: Encoder, wave: torch.Tensor,
                       key: np.ndarray):
        if state.discriminator is None:
            raise ValueError("the post-join step needs a state with a discriminator")
        if state.discriminator.cfg != self.cfg.discriminator:
            # the losses' divisors follow the step's MRD form, the maps the module's
            raise ValueError("the state's discriminator was built for another "
                             "DiscriminatorConfig than the step's")
        cfg, tc = self.cfg, self.cfg.train
        wave, angle = self.augment(wave, key)
        disc = state.discriminator
        mrd_dtype = self.operands(wave.device)
        c0 = wave.shape[1] // 2 - tc.disc_crop // 2
        with exact_fp32(), torch.enable_grad():
            logits_real, feats_real = disc(wave[:, c0:c0 + tc.disc_crop], mrd_dtype)
            fake, source = self.forward_fake(state.decoder, encoder, wave, angle)
            logits_fake, feats_fake = disc(fake[:, c0:c0 + tc.disc_crop], mrd_dtype)
            loss_spec, loss_dsp = self.spec_losses(fake, source, wave)
            loss_adv = generator_adversarial_loss(logits_fake, self.logit_counts)
            loss_feat = feature_matching_loss([f.detach() for f in feats_real], feats_fake,
                                              self.fmap_counts)
            loss_g = (loss_spec * tc.weight_spec + loss_dsp * tc.weight_dsp
                      + loss_adv * tc.weight_adv + loss_feat * tc.weight_feat)
            loss_d = discriminator_adversarial_loss(logits_real, logits_fake, self.logit_counts)
            g_grads = _grads(loss_g, state.decoder, retain_graph=True)
            d_grads = _grads(loss_d, disc)
        metrics = {"loss_spec": loss_spec.detach(), "loss_dsp": loss_dsp.detach(),
                   "loss_adv": loss_adv.detach(), "loss_feat": loss_feat.detach(),
                   "loss_d": loss_d.detach(), "loss_g": loss_g.detach()}
        g_grads, d_grads, metrics = data_mean(self.mesh, g_grads, d_grads, metrics)
        return metrics.pop("loss_g"), metrics, g_grads, d_grads

    def __call__(self, state: TrainState, encoder: Encoder, wave: torch.Tensor,
                 key: np.ndarray) -> Dict[str, torch.Tensor]:
        loss_g, metrics, g_grads, d_grads = self.loss_and_grads(state, encoder, wave, key)
        with exact_fp32():
            apply_update(state.gen_opt, state.decoder, g_grads, self.cfg)
            apply_update(state.disc_opt, state.discriminator, d_grads, self.cfg)
        state.step += 1
        metrics["loss_g"] = loss_g
        metrics["skipped_g"] = state.gen_opt.notfinite_count
        metrics["skipped_d"] = state.disc_opt.notfinite_count
        return metrics


def make_train_step(cfg: TinyVCConfig, d_join: bool, spec_loss_type: str = "ms-stft",
                    dtype_name: Optional[str] = None, mesh=None) -> TrainStep:
    """The pre-join (``d_join=False``) or post-join step; ``dtype_name``
    overrides the fused kernels' operand dtype (default: bf16 on CUDA, fp32
    on the CPU); ``mesh``: data-parallel over its data axis."""
    return (PostJoinStep if d_join else TrainStep)(cfg, spec_loss_type, dtype_name, mesh)
