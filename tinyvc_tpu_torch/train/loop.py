"""The decoder's training loop (counterpart of
`tinyvc_tpu/train/loop.py::train_decoder`, its per-step branch on one
device).

The frozen encoder comes from a params-only ``.npz``; the decoder from the
newest checkpoint in ``ckpt_dir`` when there is one (resuming its moments
and counts), else from ``init_decoder`` (an ``.npz``) or a random init
drawn from ``seed + 1``. Batches come in the JAX package's order
(`data/dataset.py`); the step keys follow its schedule: ``PRNGKey(seed +
2)``, split once per step. Losses are logged every ``log_interval`` steps
and the state saved every ``save_interval`` steps and at the end. From
``cfg.train.discriminator_join`` on, each step is the post-join one
(`tinyvc_tpu/train/loop.py:519-555`): it also logs the adversarial and
feature-matching losses and prints ``d=``. The discriminator is drawn from
``seed + 1`` after the decoder (`train/decoder_train.py::init_state`) unless
the checkpoint holds one.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..config import TinyVCConfig
from ..data.dataset import DataLoader, Dataset
from ..infer.generator import _resolve_device
from ..models.encoder import Encoder
from ..utils import prng
from ..utils.checkpoint import CheckpointManager
from ..utils.metrics import (TAG_D_ADV, TAG_DSP, TAG_FEAT, TAG_G_ADV, TAG_SKIPPED, TAG_SPEC,
                             MetricsWriter)
from ..utils.weights import encoder_from_jax, load_npz, train_state_from_jax
from . import decoder_train


def load_encoder(path: Optional[str], cfg: TinyVCConfig, seed: int, device) -> Encoder:
    """The frozen encoder from a params-only ``.npz``, or drawn at random
    (with a warning, as the JAX loop does) when ``path`` is None."""
    if path is None:
        print("WARNING: no encoder given; using a random encoder")
        enc = Encoder(cfg.encoder, cfg.audio)
        decoder_train.init_params(enc, torch.Generator().manual_seed(seed))
    else:
        if not path.endswith(".npz"):
            raise ValueError(f"{path!r}: the port reads params-only .npz exports, "
                             "not orbax checkpoint directories")
        enc = encoder_from_jax(load_npz(path), cfg.encoder)
    return enc.eval().requires_grad_(False).to(device)


def train_decoder(
    cfg: TinyVCConfig,
    dataset_dir: str = "dataset_cache",
    encoder_path: Optional[str] = None,
    ckpt_dir: str = "models/decoder",
    log_dir: str = "./logs",
    max_steps: Optional[int] = None,
    spec_loss_type: str = "ms-stft",
    seed: int = 0,
    device: str = "cuda",
    init_decoder: Optional[str] = None,
) -> decoder_train.TrainState:
    """Train the decoder to ``max_steps`` (default ``cfg.train.max_steps``)
    on ``device`` (CUDA by default; it raises when CUDA is absent)."""
    device = _resolve_device(device)
    max_steps = cfg.train.max_steps if max_steps is None else max_steps
    loader = DataLoader(Dataset(dataset_dir), cfg.train.batch_size, seed=seed)
    if len(loader) == 0:
        raise ValueError(f"{dataset_dir!r} holds fewer chunks than one batch "
                         f"({cfg.train.batch_size})")
    encoder = load_encoder(encoder_path, cfg, seed, device)
    state = decoder_train.init_state(cfg, seed + 1, device)
    if init_decoder is not None:
        init = train_state_from_jax(load_npz(init_decoder), cfg.decoder, cfg.audio, device)
        state.decoder, state.gen_opt = init.decoder, init.gen_opt
    ckpt = CheckpointManager(ckpt_dir)
    if ckpt.restore(state) is not None:
        print(f"resumed decoder training at step {state.step} "
              "(optimizer state and join gate preserved)")

    steps = {d_join: decoder_train.make_train_step(cfg, d_join, spec_loss_type)
             for d_join in (False, True)}
    key = prng.prng_key(seed + 2)
    step = state.step
    t0 = t_log = time.time()
    s_log = step
    with MetricsWriter(log_dir) as writer:
        while step < max_steps:
            for batch in loader:
                if step >= max_steps:
                    break
                d_join = step >= cfg.train.discriminator_join
                key, sub = prng.split(key)
                wave = torch.from_numpy(batch["wave"]).to(device)
                metrics = steps[d_join](state, encoder, wave, sub)
                step += 1
                if step % cfg.train.log_interval == 0:
                    scalars = {TAG_SPEC: metrics["loss_spec"], TAG_DSP: metrics["loss_dsp"]}
                    if d_join:
                        scalars[TAG_G_ADV] = metrics["loss_adv"]
                        scalars[TAG_FEAT] = metrics["loss_feat"]
                        scalars[TAG_D_ADV] = metrics["loss_d"]
                    skipped = int(metrics["skipped_g"]) + int(metrics.get("skipped_d", 0))
                    if skipped:
                        scalars[TAG_SKIPPED] = skipped
                    writer.write(step, scalars)
                    now = time.time()
                    sps = (step - s_log) / max(now - t_log, 1e-9)
                    t_log, s_log = now, step
                    print(f"step {step} spec={float(metrics['loss_spec']):.4f} "
                          f"dsp={float(metrics['loss_dsp']):.4f} "
                          + (f"d={float(metrics['loss_d']):.4f} " if d_join else "")
                          + (f"SKIPPED={skipped} " if skipped else "")
                          + f"({sps:.2f} steps/s, {now - t0:.0f}s)", flush=True)
                if step % cfg.train.save_interval == 0:
                    ckpt.save(step, state, cfg)
    ckpt.save(state.step, state, cfg)
    return state
