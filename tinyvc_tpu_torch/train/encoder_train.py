"""The encoder's training step: pitch classification and distillation
(counterpart of `tinyvc_tpu/train/encoder_train.py`).

The loss is the weighted cross entropy of the pitch classes (the unvoiced
class 0 weighted ``unvoiced_class_weight``) plus ``distill_weight`` times
the L1 distance between the content head and the teacher's features,
brought to the encoder's frames by :func:`linear_interp_time`. The labels
come from the clean f0; only then is each row of the wave scaled by ``2 *
uniform(key, (B, 1))`` (`utils/prng.py`, JAX's own numbers), and the student
sees the scaled wave's spectrogram. A step without a teacher
(``distill=False``) drops the distillation term: the content head gets a
zero gradient and still takes AdamW's weight decay, as optax gives it.

The optimizer is optax's ``chain(clip_by_global_norm(1.0), adamw(lr))``
with its defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4) and no
skip of non-finite steps: `train/decoder_train.py::apply_update` with those
betas and ``skip_nonfinite=False``. The step runs with TF32 off
(`infer/generator.py::exact_fp32`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import TinyVCConfig
from ..dsp.interp import linear_interp_time
from ..dsp.stft import spectrogram
from ..infer.generator import _resolve_device, exact_fp32
from ..models.encoder import Encoder, freq2id
from ..parallel.mesh import data_mean, global_rows
from ..utils import prng
from .decoder_train import OptState, _grads, apply_update, init_params

ADAM_BETAS = (0.9, 0.999)  # optax.adamw's defaults


@dataclasses.dataclass
class EncoderTrainState:
    """The encoder (its parameters), AdamW's state and the step
    (`EncoderTrainState`)."""

    encoder: Encoder
    opt: OptState
    step: int = 0


def init_state(cfg: TinyVCConfig, seed: int, device="cuda") -> EncoderTrainState:
    """A fresh state: the encoder drawn by `decoder_train.init_params` (flax's
    initializers) from ``torch.Generator().manual_seed(seed)``, zero moments.
    On CUDA unless ``device`` asks for the CPU (it raises without a card)."""
    device = _resolve_device(device)
    enc = Encoder(cfg.encoder, cfg.audio)
    init_params(enc, torch.Generator().manual_seed(seed))
    enc = enc.train().to(device)
    return EncoderTrainState(enc, OptState.fresh(enc))


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor, mesh=None) -> torch.Tensor:
    """``F.cross_entropy(weight=w)``'s semantics on ``[..., classes]``
    logits: each element's NLL scaled by ``w[label]``, summed, over the
    summed weights. With ``mesh``, over the global batch: the weights are
    summed over the data group, and this rank's sum is scaled by the group's
    size, so that the ranks' mean is the global loss (and the mean of their
    gradients its gradient)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    w = class_weights[labels]
    den = torch.sum(w)
    if mesh is None:
        return torch.sum(w * nll) / den
    dist.all_reduce(den, group=mesh.data_group)  # the labels carry no gradient
    return torch.sum(w * nll) * mesh.data / den


def encoder_loss(encoder: Encoder, spec: torch.Tensor, labels: torch.Tensor,
                 teacher: Optional[torch.Tensor], class_weights: torch.Tensor,
                 distill_weight: float, mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss_f0", "loss_distill"}); ``distill_weight`` 0 runs the
    pitch head alone and reports a distillation loss of 0. ``mesh``: this
    rank's share of the global batch's loss (:func:`weighted_cross_entropy`;
    the distillation term is a mean over equal shares)."""
    if not distill_weight:
        loss_f0 = weighted_cross_entropy(encoder.pitch_estimator(spec), labels, class_weights,
                                         mesh)
        return loss_f0, {"loss_f0": loss_f0, "loss_distill": torch.zeros((), device=spec.device)}
    z, logits = encoder(spec)
    loss_f0 = weighted_cross_entropy(logits, labels, class_weights, mesh)
    loss_distill = torch.mean(torch.abs(z - linear_interp_time(teacher, z.shape[1])))
    loss = loss_f0 + loss_distill * distill_weight
    return loss, {"loss_f0": loss_f0, "loss_distill": loss_distill}


class EncoderTrainStep:
    """`make_train_step`'s step: ``step(state, wave [B, L], f0 [B, F],
    teacher [B, Ft, D] or None, key)`` updates ``state`` in place and returns
    the metrics ``loss``, ``loss_f0`` and ``loss_distill`` (device scalars).
    ``loss_and_grads`` returns (loss, metrics, gradients by parameter name)
    without touching the state. With ``mesh``, data-parallel as the
    decoder's step is (`train/decoder_train.py::TrainStep`): this rank's
    rows, the gain drawn over the global batch, the gradients and losses
    averaged over the data group before the update."""

    def __init__(self, cfg: TinyVCConfig, distill: bool = True, mesh=None):
        self.cfg = cfg
        self.distill = distill
        self.mesh = mesh
        self._weights = {}

    def class_weights(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._weights:
            w = torch.ones(self.cfg.encoder.num_pitch_classes)
            w[0] = self.cfg.train.unvoiced_class_weight
            self._weights[device] = w.to(device)
        return self._weights[device]

    def inputs(self, wave: torch.Tensor, f0: torch.Tensor, key: np.ndarray):
        """(labels from the clean f0, the gain-scaled wave's spectrogram)."""
        e, a = self.cfg.encoder, self.cfg.audio
        labels = freq2id(f0.float(), e.num_pitch_classes, e.classes_per_octave, e.min_frequency)
        B, rows = global_rows(self.mesh, wave.shape[0])
        gain = torch.from_numpy(prng.uniform(np.asarray(key, np.uint32), (B, 1), rows=rows))
        wave = wave.float() * (gain.to(wave.device) * 2.0)
        return labels, spectrogram(wave, a.n_fft, a.hop_size)

    def loss_and_grads(self, state: EncoderTrainState, wave: torch.Tensor, f0: torch.Tensor,
                       teacher: Optional[torch.Tensor], key: np.ndarray):
        weight = self.cfg.train.distill_weight if self.distill else 0.0
        with exact_fp32(), torch.enable_grad():
            labels, spec = self.inputs(wave, f0, key)
            loss, metrics = encoder_loss(state.encoder, spec, labels, teacher,
                                         self.class_weights(wave.device), weight, self.mesh)
            grads = _grads(loss, state.encoder)
        metrics = {k: v.detach() for k, v in {"loss": loss, **metrics}.items()}
        grads, metrics = data_mean(self.mesh, grads, metrics)
        return metrics.pop("loss"), metrics, grads

    def __call__(self, state: EncoderTrainState, wave: torch.Tensor, f0: torch.Tensor,
                 teacher: Optional[torch.Tensor], key: np.ndarray) -> Dict[str, torch.Tensor]:
        loss, metrics, grads = self.loss_and_grads(state, wave, f0, teacher, key)
        with exact_fp32():
            apply_update(state.opt, state.encoder, grads, self.cfg, betas=ADAM_BETAS,
                         skip_nonfinite=False)
        state.step += 1
        metrics["loss"] = loss
        return metrics


def make_train_step(cfg: TinyVCConfig, distill: bool = True, mesh=None) -> EncoderTrainStep:
    """The step with (``distill=True``) or without the distillation term;
    without it the teacher argument is ignored (pass None). ``mesh``:
    data-parallel over its data axis."""
    return EncoderTrainStep(cfg, distill, mesh)
