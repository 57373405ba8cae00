"""The port's post-join GAN step against the JAX package's
``make_train_step(cfg, d_join=True)`` on the CPU, fp32, at
`tests/test_training.py::small_config`'s widths: the same generator and
discriminator parameters (carried across with
`utils/weights.py::train_state_from_jax`), encoder, wave and key, with the
MRD as the conv form ("lax") and as the fused phase-plane chain ("fused";
JAX runs its Pallas kernels in interpret mode). The log-mel loss and an
unvoiced pitch: the multi-scale STFT loss's gradient is chaotic and the
harmonics' phase rounding differs by design (ROADMAP.md §3)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models import Decoder, Encoder
from tinyvc_tpu.models.discriminator import Discriminator
from tinyvc_tpu.train import decoder_train as jdt
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.train import decoder_train as pdt
from tinyvc_tpu_torch.utils.weights import (encoder_from_jax, state_dict_from_jax,
                                            train_state_from_jax)
from torch_parity import random_params

ENC = dict(pitch_channels=16, pitch_num_layers=1, ssl_channels=16, ssl_dilations=(1,), ssl_dim=32)
DEC = dict(source_channels=16, source_num_layers=1, filter_channels=(32, 24, 16, 12, 8),
           content_channels=32)
DISC = dict(periods=(2, 3), resolutions=(32,), channels=4, max_channels=16, num_layers=2)
TRAIN = dict(batch_size=2, chunk_length=4800, disc_crop=2400)
F, L = 10, 4800
LOSSES = ("loss_spec", "loss_dsp", "loss_adv", "loss_feat", "loss_g", "loss_d")


@pytest.fixture(autouse=True)
def _two_threads():
    """At most two intra-op threads per test: the tier-1 run puts six workers
    on the CPU's cores, where more threads per worker only spin against each
    other's (a full-width discriminator test took 300x its single-process
    time so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _configs(impl):
    jc = jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC), decoder=jcfg.DecoderConfig(**DEC),
                           discriminator=jcfg.DiscriminatorConfig(mrd_conv_impl=impl, **DISC),
                           train=jcfg.TrainConfig(**TRAIN))
    pc = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC), decoder=pcfg.DecoderConfig(**DEC),
                           discriminator=pcfg.DiscriminatorConfig(mrd_conv_impl=impl, **DISC),
                           train=pcfg.TrainConfig(**TRAIN))
    return jc, pc


def _setup(rng, impl):
    """JAX's state (generator and discriminator), encoder parameters and a
    wave; the random pitch head steered to class 0, which decodes as
    unvoiced, so that the harmonics are exactly zero on both sides."""
    jc, pc = _configs(impl)
    enc_p = random_params(Encoder(jc.encoder), jnp.zeros((1, F, 961)))
    head = enc_p["params"]["pitch_estimator"]["stack"]["output_layer"]
    head["bias"] = head["bias"] + 1000.0 * (np.arange(512) == 0)
    dec_p = random_params(Decoder(jc.decoder, jc.audio), jnp.zeros((1, F, 32)),
                          jnp.full((1, F), 100.0), jnp.zeros((1, L)), jnp.zeros((2,), jnp.uint32))
    disc_p = random_params(Discriminator(jc.discriminator), jnp.zeros((1, TRAIN["disc_crop"])))
    gtx, dtx = jdt.make_optimizers(jc)
    state = jdt.GanTrainState(gen_params=dec_p, disc_params=disc_p, gen_opt=gtx.init(dec_p),
                              disc_opt=dtx.init(disc_p), step=jnp.zeros((), jnp.int32))
    t = np.arange(L) / 24000
    f = rng.uniform(90, 250, (2, 1))
    wave = (0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal((2, L)))
    wave = wave.astype(np.float32)
    wave[1, 1000:2000] = 0.0
    return jc, pc, state, enc_p, wave


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


def _first_moment_grads(opt):
    """JAX's gradients of one step from zero moments: its first moment is
    ``(1 - b1) * clip(g)``."""
    mu = opt.inner[1][0].mu
    return {k: v / 0.2 for k, v in state_dict_from_jax({"params": mu["params"]}).items()}


def _leaf_errors(grads, want):
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    clip = min(1.0, 1.0 / gnorm)
    assert set(want) == set(grads)
    return {k: float((grads[k] * clip - want[k]).norm() / (want[k].norm() or 1.0))
            for k in grads}


def _param_diff(module, want_tree):
    want = state_dict_from_jax(want_tree)
    return torch.cat([(p.detach() - want[k]).abs().flatten()
                      for k, p in module.named_parameters()])


@pytest.mark.parametrize("impl", ["lax", "fused"])
def test_postjoin_step_matches_jax(rng, impl):
    """The six losses within 1e-5 relative; every gradient leaf of both
    networks within 1e-3 relative norm; the parameters after one update
    within a small fraction of the learning rate."""
    jc, pc, state, enc_p, wave = _setup(rng, impl)
    jstep = jdt.make_train_step(jc, d_join=True, spec_loss_type="mel")
    s1, m1 = jstep(state, enc_p, jnp.asarray(wave), jax.random.PRNGKey(5))

    ps = train_state_from_jax(state, pc.decoder, pc.audio, disc_cfg=pc.discriminator)
    enc = encoder_from_jax(enc_p, pc.encoder)
    step = pdt.make_train_step(pc, d_join=True, spec_loss_type="mel")
    loss_g, metrics, g_grads, d_grads = step.loss_and_grads(ps, enc, torch.from_numpy(wave),
                                                            _key(5))
    metrics["loss_g"] = loss_g
    for name in LOSSES:
        want, got = float(m1[name]), float(metrics[name])
        print(f"{impl}: {name} {got:.7f} vs JAX {want:.7f}, relative "
              f"{abs(got - want) / abs(want):.2e}")
        assert abs(got - want) <= 1e-5 * abs(want)

    for label, grads, opt in (("generator", g_grads, s1.gen_opt),
                              ("discriminator", d_grads, s1.disc_opt)):
        errs = _leaf_errors(grads, _first_moment_grads(opt))
        worst = sorted(errs, key=errs.get, reverse=True)[:3]
        print(f"{impl}: {label} gradients, {len(errs)} leaves, worst "
              + ", ".join(f"{k} {errs[k]:.2e}" for k in worst))
        assert errs[worst[0]] <= 1e-3

    metrics = step(ps, enc, torch.from_numpy(wave), _key(5))
    assert metrics["skipped_g"] == 0 and metrics["skipped_d"] == 0
    assert ps.step == 1 and ps.gen_opt.count == 1 and ps.disc_opt.count == 1
    lr = pc.train.learning_rate
    for label, module, tree in (("generator", ps.decoder, s1.gen_params),
                                ("discriminator", ps.discriminator, s1.disc_params)):
        diff = _param_diff(module, tree)
        print(f"{impl}: {label} after one update max |dp| {float(diff.max()):.3e} "
              f"({float(diff.max()) / lr:.2f} lr), {int((diff > 0.01 * lr).sum())} of "
              f"{diff.numel()} beyond 0.01 lr")
        # AdamW's first step moves a parameter by ~lr * sign(g): a gradient
        # element ~0 on both sides may take opposite signs, 2 lr apart
        assert float(diff.max()) <= 2.5 * lr
        assert int((diff > 0.01 * lr).sum()) <= 1e-3 * diff.numel()


def test_nonfinite_gradient_skips_only_its_own_optimizer(rng):
    """A NaN in one discriminator gradient: the discriminator's parameters,
    moments and count stay, its skip is counted; the generator updates."""
    _, pc, state, enc_p, wave = _setup(rng, "lax")
    ps = train_state_from_jax(state, pc.decoder, pc.audio, disc_cfg=pc.discriminator)
    enc = encoder_from_jax(enc_p, pc.encoder)
    step = pdt.make_train_step(pc, d_join=True, spec_loss_type="mel")
    out = step.loss_and_grads(ps, enc, torch.from_numpy(wave), _key(1))
    out[3]["mrd_32.post.v"][0, 0, 0, 0] = math.nan
    step.loss_and_grads = lambda *a: out
    disc = {n: p.detach().clone() for n, p in ps.discriminator.named_parameters()}
    gen = {n: p.detach().clone() for n, p in ps.decoder.named_parameters()}
    metrics = step(ps, enc, torch.from_numpy(wave), _key(1))
    assert metrics["skipped_d"] == 1 and metrics["skipped_g"] == 0
    assert ps.disc_opt.count == 0 and ps.gen_opt.count == 1
    assert all(torch.equal(p, disc[n]) for n, p in ps.discriminator.named_parameters())
    assert all(float(m.abs().max()) == 0.0 for m in ps.disc_opt.mu.values())
    assert any(not torch.equal(p, gen[n]) for n, p in ps.decoder.named_parameters())


def test_train_state_carries_the_discriminator_from_jax(rng):
    """`train_state_from_jax` carries ``disc_params`` and ``disc_opt``'s
    moments, Adam's count and skip count (after one JAX step)."""
    jc, pc, state, enc_p, wave = _setup(rng, "lax")
    s1, _ = jdt.make_train_step(jc, d_join=True, spec_loss_type="mel")(
        state, enc_p, jnp.asarray(wave), jax.random.PRNGKey(2))
    ps = train_state_from_jax(s1, pc.decoder, pc.audio, disc_cfg=pc.discriminator)
    assert ps.step == 1 and ps.disc_opt.count == 1 and ps.disc_opt.notfinite_count == 0
    want = state_dict_from_jax(s1.disc_params)
    assert all(torch.equal(p.detach(), want[n]) for n, p in ps.discriminator.named_parameters())
    nu = state_dict_from_jax({"params": s1.disc_opt.inner[1][0].nu["params"]})
    assert all(torch.equal(ps.disc_opt.nu[n], nu[n]) for n in nu)
    assert dataclasses.asdict(pc.discriminator) == dataclasses.asdict(jc.discriminator)
