"""The port's pre-join decoder training step against the JAX package's
``make_train_step(cfg, d_join=False)`` on the CPU, fp32, at small widths
(`tests/test_training.py::small_config` with ``chunk_length`` 9600), the
fused U-Net on both sides (``use_fused_filter_train="on"``; JAX runs its
Pallas kernels in interpret mode): the same parameters (carried across with
`utils/weights.py::train_state_from_jax`), encoder, wave and key; the port
draws the gain and the noise phases from that key itself. And the
optimizer against optax, and its skip of a non-finite step."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models import Decoder, Encoder
from tinyvc_tpu.train import decoder_train as jdt
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.train import decoder_train as pdt
from tinyvc_tpu_torch.train import encoder_train as pet
from tinyvc_tpu_torch.train.loop import load_encoder
from tinyvc_tpu_torch.utils.weights import (encoder_from_jax, state_dict_from_jax,
                                            train_state_from_jax)
from torch_parity import random_params

ENC = dict(pitch_channels=16, pitch_num_layers=1, ssl_channels=16, ssl_dilations=(1,), ssl_dim=32)
DEC = dict(source_channels=16, source_num_layers=1, filter_channels=(32, 24, 16, 12, 8),
           content_channels=32, use_fused_filter_train="on")
TRAIN = dict(batch_size=2, chunk_length=9600)
F, L = 20, 9600


def _configs():
    jc = jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC), decoder=jcfg.DecoderConfig(**DEC),
                           train=jcfg.TrainConfig(**TRAIN))
    pc = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC), decoder=pcfg.DecoderConfig(**DEC),
                           train=pcfg.TrainConfig(**TRAIN))
    return jc, pc


def _setup(rng, voiced: bool):
    """JAX's state, encoder parameters and a wave: two voiced rows, the
    second with a silent stretch. ``voiced`` steers the random pitch head
    to class 140 (~150 Hz) as `tests/test_torch_convert.py` does; else to
    class 0, which decodes as unvoiced, so that the harmonics are exactly
    zero on both sides (their phase rounding differs by design, ROADMAP.md
    §3)."""
    jc, pc = _configs()
    enc_p = random_params(Encoder(jc.encoder), jnp.zeros((1, F, 961)))
    head = enc_p["params"]["pitch_estimator"]["stack"]["output_layer"]
    if voiced:
        head["bias"] = head["bias"] + 8.0 * np.exp(-(((np.arange(512) - 140) / 20.0) ** 2))
    else:
        head["bias"] = head["bias"] + 1000.0 * (np.arange(512) == 0)
    dec_p = random_params(Decoder(jc.decoder, jc.audio), jnp.zeros((1, F, 32)),
                          jnp.full((1, F), 100.0), jnp.zeros((1, L)), jnp.zeros((2,), jnp.uint32))
    gtx, dtx = jdt.make_optimizers(jc)
    state = jdt.GanTrainState(gen_params=dec_p, disc_params={}, gen_opt=gtx.init(dec_p),
                              disc_opt=dtx.init({}), step=jnp.zeros((), jnp.int32))
    t = np.arange(L) / 24000
    f = rng.uniform(90, 250, (2, 1))
    wave = (0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal((2, L)))
    wave = wave.astype(np.float32)
    wave[1, 3000:4500] = 0.0
    return jc, pc, state, enc_p, wave


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


def _grads_from_first_moment(state_after_one_step):
    """JAX's gradients of one step from zero moments: its first moment is
    ``(1 - b1) * clip(g)``."""
    mu = state_after_one_step.gen_opt.inner[1][0].mu
    return {k: v / 0.2 for k, v in state_dict_from_jax({"params": mu["params"]}).items()}


@pytest.mark.parametrize("spec_loss,voiced", [("mel", False), ("ms-stft", True)])
def test_prejoin_step_matches_jax(rng, spec_loss, voiced):
    """The losses within 1e-4 relative in both cases; every gradient leaf
    within 1e-3 relative norm with the log-mel loss and identical sources.
    With the multi-scale STFT loss the gradients are chaotic in the
    waveform (`tests/test_torch_train_unet.py::
    test_ms_stft_gradient_is_chaotic`): the port misses the 1e-3 bound
    there, recorded as a fault in ROADMAP.md §3 with these numbers, which
    this case prints."""
    jc, pc, state, enc_p, wave = _setup(rng, voiced)
    jstep = jdt.make_train_step(jc, d_join=False, spec_loss_type=spec_loss)
    s1, m1 = jstep(state, enc_p, jnp.asarray(wave), jax.random.PRNGKey(5))
    s2, _ = jstep(s1, enc_p, jnp.asarray(wave), jax.random.PRNGKey(6))

    ps = train_state_from_jax(state, pc.decoder, pc.audio)
    enc = encoder_from_jax(enc_p, pc.encoder)
    step = pdt.make_train_step(pc, d_join=False, spec_loss_type=spec_loss)
    loss, metrics, grads = step.loss_and_grads(ps, enc, torch.from_numpy(wave), _key(5))

    for name in ("loss_spec", "loss_dsp"):
        want, got = float(m1[name]), float(metrics[name])
        print(f"{spec_loss}: {name} {got:.6f} vs JAX {want:.6f}")
        assert abs(got - want) <= 1e-4 * abs(want)
    assert abs(float(loss) - float(m1["loss_g"])) <= 1e-4 * abs(float(m1["loss_g"]))

    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    clip = min(1.0, pc.train.grad_clip / gnorm)
    want = _grads_from_first_moment(s1)
    assert set(want) == set(grads)
    # a leaf with no gradient on JAX's side (the amplitudes' head without
    # voicing) must have none on the port's: its error is then the norm
    errs = {k: float((grads[k] * clip - want[k]).norm() / (want[k].norm() or 1.0))
            for k in grads}
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    print(f"{spec_loss}: gradient norm {gnorm:.4g}; worst leaves "
          + ", ".join(f"{k} {errs[k]:.2e}" for k in worst))
    if spec_loss == "mel":
        assert errs[worst[0]] <= 1e-3

    metrics = step(ps, enc, torch.from_numpy(wave), _key(5))
    assert metrics["skipped_g"] == 0 and ps.step == 1 and ps.gen_opt.count == 1
    step(ps, enc, torch.from_numpy(wave), _key(6))
    want = state_dict_from_jax(s2.gen_params)
    diff = torch.cat([(p.detach() - want[k]).abs().flatten()
                      for k, p in ps.decoder.named_parameters()])
    lr = pc.train.learning_rate
    print(f"{spec_loss}: after two updates max |dp| {float(diff.max()):.3e} "
          f"({float(diff.max()) / lr:.2f} lr), {int((diff > 0.01 * lr).sum())} of {diff.numel()} "
          "beyond 0.01 lr")
    if spec_loss == "mel":
        # AdamW moves a parameter by ~lr * sign(g) a step: a gradient element
        # that is ~0 on both sides may take opposite signs, up to 4 lr apart
        # after two steps; everything else agrees to a small fraction of lr
        assert float(diff.max()) <= 4 * lr
        assert int((diff > 0.01 * lr).sum()) <= 1e-3 * diff.numel()


def _optax_tx(cfg):
    return jdt.skip_if_nonfinite(optax.chain(
        optax.clip_by_global_norm(cfg.train.grad_clip),
        optax.adamw(cfg.train.learning_rate, b1=cfg.train.adam_betas_gan[0],
                    b2=cfg.train.adam_betas_gan[1])))


def test_optimizer_matches_optax(rng):
    """`apply_update` against optax's ``skip_if_nonfinite(chain(
    clip_by_global_norm(1), adamw(1e-4, 0.8, 0.99)))``: steps with a small
    gradient (no clipping), a large one (clipped), and a non-finite one
    (skipped: the update, the moments and Adam's count untouched, the skip
    counted, as `tests/test_training.py::test_skip_if_nonfinite_guard`
    checks for JAX). Elementwise fp32: within a few ulps."""
    _, pc = _configs()
    dec = pdt.init_state(pc, 3, "cpu").decoder
    names = [n for n, _ in dec.named_parameters()][:6]
    state = pdt.OptState.fresh(dec)
    params = {n: p.detach().numpy().copy() for n, p in dec.named_parameters()}
    tx = _optax_tx(pc)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = tx.init(jp)
    for scale, bad in ((1e-3, None), (10.0, None), (1e-3, math.nan), (1.0, None),
                       (1e-3, math.inf)):
        g = {n: (scale * rng.standard_normal(v.shape)).astype(np.float32)
             for n, v in params.items()}
        if bad is not None:
            g[names[2]].flat[0] = bad
        upd, jstate = tx.update({n: jnp.asarray(v) for n, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        mu_before = {n: t.clone() for n, t in state.mu.items()}
        took = pdt.apply_update(state, dec, {n: torch.from_numpy(v) for n, v in g.items()}, pc)
        assert took == (bad is None)
        if bad is not None:
            assert all(torch.equal(state.mu[n], mu_before[n]) for n in names)
        for n, p in dec.named_parameters():
            want = np.asarray(jp[n])
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=4 * np.spacing(np.abs(want).max()), err_msg=n)
        adam = jstate.inner.inner[1][0] if hasattr(jstate.inner, "inner") else jstate.inner[1][0]
        assert state.count == int(adam.count)
        assert state.notfinite_count == int(jstate.notfinite_count)
    assert state.notfinite_count == 2 and state.count == 3


def test_nan_gradient_skips_the_step(rng):
    """A NaN in one gradient of a real step: no parameter, moment or count
    moves, the skip is counted, and the next finite step updates."""
    jc, pc, state, enc_p, wave = _setup(rng, voiced=True)
    ps = train_state_from_jax(state, pc.decoder, pc.audio)
    enc = encoder_from_jax(enc_p, pc.encoder)
    step = pdt.make_train_step(pc, d_join=False)
    _, _, grads = step.loss_and_grads(ps, enc, torch.from_numpy(wave), _key(1))
    before = {n: p.detach().clone() for n, p in ps.decoder.named_parameters()}
    grads["filter_net.up_4.c1.weight"][0, 0, 0] = math.nan
    assert not pdt.apply_update(ps.gen_opt, ps.decoder, grads, pc)
    assert ps.gen_opt.notfinite_count == 1 and ps.gen_opt.count == 0
    assert all(torch.equal(p, before[n]) for n, p in ps.decoder.named_parameters())
    assert all(float(m.abs().max()) == 0.0 for m in ps.gen_opt.mu.values())
    metrics = step(ps, enc, torch.from_numpy(wave), _key(2))
    assert metrics["skipped_g"] == 1 and ps.gen_opt.count == 1 and ps.step == 1


def test_post_join_builds_and_steps(rng):
    """``d_join=True`` builds the post-join step, which updates both
    networks from one state (a small discriminator; its parity with JAX is
    `tests/test_torch_train_postjoin.py`'s)."""
    _, pc = _configs()
    pc = dataclasses.replace(
        pc, discriminator=pcfg.DiscriminatorConfig(periods=(2, 3), resolutions=(32,), channels=4,
                                                   max_channels=16, num_layers=2),
        train=dataclasses.replace(pc.train, disc_crop=2400))
    st = pdt.init_state(pc, 1, "cpu")
    disc_before = {n: p.detach().clone() for n, p in st.discriminator.named_parameters()}
    step = pdt.make_train_step(pc, d_join=True, spec_loss_type="mel")
    assert isinstance(step, pdt.PostJoinStep)
    wave = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    metrics = step(st, load_encoder(None, pc, 0, "cpu"), torch.from_numpy(wave), _key(3))
    assert all(np.isfinite(float(metrics[k])) for k in
               ("loss_spec", "loss_dsp", "loss_adv", "loss_feat", "loss_g", "loss_d"))
    assert metrics["skipped_g"] == 0 and metrics["skipped_d"] == 0 and st.step == 1
    assert st.gen_opt.count == 1 and st.disc_opt.count == 1
    assert all(not torch.equal(p, disc_before[n])
               for n, p in st.discriminator.named_parameters())


def test_init_state_draws_flax_distributions():
    """Random init: kernels and biases uniform within 1/sqrt(fan_in) of the
    kernel, LayerNorm gains 1, GRN and shifts 0; zero moments."""
    _, pc = _configs()
    st = pdt.init_state(pc, 0, "cpu")
    for name, p in st.decoder.named_parameters():
        assert torch.equal(st.gen_opt.mu[name], torch.zeros_like(p))
    sub = st.decoder.filter_net.up_4.c1
    bound = 1.0 / math.sqrt(sub.weight.shape[1] * sub.weight.shape[2])
    assert float(sub.weight.abs().max()) <= bound and float(sub.bias.abs().max()) <= bound
    assert float(sub.weight.abs().max()) > 0.9 * bound
    layer = st.decoder.source_net.layer_0
    assert torch.equal(layer.norm.gamma, torch.ones_like(layer.norm.gamma))
    assert float(layer.grn.gamma.abs().max()) == 0.0
    again = pdt.init_state(pc, 0, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(st.decoder.parameters(),
                                                  again.decoder.parameters()))


@pytest.mark.parametrize("module", (pdt, pet))
def test_init_state_runs_on_the_card_unless_asked(monkeypatch, module):
    """Both trainers' ``init_state`` default to CUDA, as the port's entry
    points do, and raise ``_resolve_device``'s error without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        module.init_state(_configs()[1], 0)
