"""The port's encoder training step (`tinyvc_tpu_torch/train/encoder_train.py`)
against the JAX package's (`tinyvc_tpu/train/encoder_train.py`) at small
widths, from one state carried across (`utils/weights.py::
encoder_train_state_from_jax`) on the same batch and key: ``freq2id``, the
weighted cross entropy and ``linear_interp_time``; the gain draw bit for
bit; the losses, every gradient leaf, and the parameters and AdamW's
moments after one and two steps, with and without distillation; and the
teacher-less step's content head, whose gradient is exactly zero and whose
parameters move by weight decay alone.

Tolerances, measured before they were fixed: the losses 1e-6 relative
(measured 1.3e-7), each gradient leaf 1e-5 of its peak (9.5e-7), the
parameters 1e-5 absolute after two steps (6.3e-7; a sign flip of a
near-zero gradient would move one by twice the learning rate, 2e-4), the
moments 1e-5 of each leaf's peak (1.7e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_training import small_config
from tinyvc_tpu.dsp import spectrogram as jax_spectrogram
from tinyvc_tpu.dsp.interp import linear_interp_time as jax_interp_time
from tinyvc_tpu.models import Encoder as JaxEncoder
from tinyvc_tpu.models import freq2id as jax_freq2id
from tinyvc_tpu.train import encoder_train as jet
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.dsp.interp import linear_interp_time
from tinyvc_tpu_torch.models.encoder import freq2id
from tinyvc_tpu_torch.train import encoder_train as pet
from tinyvc_tpu_torch.train.decoder_train import WEIGHT_DECAY
from tinyvc_tpu_torch.utils import prng
from tinyvc_tpu_torch.utils.weights import (encoder_train_state_from_jax, jax_name,
                                            to_jax_layout)
from torch_parity import random_params

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5  # of each leaf's peak
PARAM_ATOL = 1e-5
MOMENT_TOL = 1e-5  # of each leaf's peak
B, L = 2, 4800
F = L // 480


def port_config():
    """`tests/test_training.py::small_config` in the port's classes."""
    return pcfg.TinyVCConfig(
        encoder=pcfg.EncoderConfig(pitch_channels=16, pitch_num_layers=1, ssl_channels=16,
                                   ssl_dilations=(1,), ssl_dim=32),
        train=pcfg.TrainConfig(batch_size=B, chunk_length=L))


def batch(rng):
    """A voiced wave with noise, f0 with unvoiced frames, 7 teacher frames."""
    t = np.arange(L) / 24000
    wave = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (B, 1)) * t)
            + 0.05 * rng.standard_normal((B, L))).astype(np.float32)
    f0 = rng.uniform(60, 400, (B, F)).astype(np.float32)
    f0[:, :3] = 0.0
    teacher = (0.3 * rng.standard_normal((B, 7, 32))).astype(np.float32)
    return wave, f0, teacher


def jax_state(cfg):
    """JAX's train state with random parameters (GRN's gains non-zero)."""
    params = random_params(JaxEncoder(cfg.encoder), jnp.zeros((1, F, cfg.audio.fft_bin)))
    return jet.EncoderTrainState(params=params, opt_state=jet.make_optimizer(cfg).init(params),
                                 step=jnp.zeros((), jnp.int32))


def leaf(tree, name):
    for part in jax_name(name).split("/"):
        tree = tree[part]
    return np.asarray(tree)


def rel_peak(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_freq2id_matches_jax():
    f = np.array([0.0, 5.0, 19.99, 20.0, 20.5, 55.0, 110.0, 220.0, 441.3, 1000.0,
                  7000.0, 24000.0, 1e6], np.float32)
    want = np.asarray(jax_freq2id(jnp.asarray(f), 512, 48, 20.0))
    got = freq2id(torch.from_numpy(f), 512, 48, 20.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[-1] == 511  # unvoiced -> class 0; above the range -> the top


def test_weighted_cross_entropy_and_interp_match_jax(rng):
    logits = rng.standard_normal((2, 7, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (2, 7))
    w = rng.uniform(0.1, 1.0, 10).astype(np.float32)
    want = float(jet.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                            jnp.asarray(w)))
    got = float(pet.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                           torch.from_numpy(w)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    for n in (3, 7, 10, 16):
        np.testing.assert_allclose(linear_interp_time(torch.from_numpy(x), n).numpy(),
                                   np.asarray(jax_interp_time(jnp.asarray(x), n)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("distill", [True, False], ids=["distill", "pitch_only"])
def test_step_matches_jax(rng, distill):
    cfg, pc = small_config(), port_config()
    wave, f0, teacher = batch(rng)
    st = jax_state(cfg)
    key = jax.random.PRNGKey(5)
    # the gain: jax.random.uniform's bits
    np.testing.assert_array_equal(prng.uniform(np.asarray(key), (B, 1)),
                                  np.asarray(jax.random.uniform(key, (B, 1))))
    # one step's losses and gradients
    enc = JaxEncoder(cfg.encoder)
    cw = jnp.ones((512,)).at[0].set(cfg.train.unvoiced_class_weight)
    labels = jax_freq2id(jnp.asarray(f0), 512, 48, 20.0)
    spec = jax_spectrogram(jnp.asarray(wave) * (jax.random.uniform(key, (B, 1)) * 2.0), 1920, 480)
    weight = cfg.train.distill_weight if distill else 0.0
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jet.encoder_loss(enc, p, spec, labels, jnp.asarray(teacher), cw, weight),
        has_aux=True))(st.params)
    ps = encoder_train_state_from_jax(jax.device_get(st), pc.encoder)
    step = pet.make_train_step(pc, distill)
    args = (torch.from_numpy(wave), torch.from_numpy(f0), torch.from_numpy(teacher))
    pl, pm, pg = step.loss_and_grads(ps, *args, np.asarray(key))
    for got, want in [(pl, jl)] + [(pm[k], jm[k]) for k in ("loss_f0", "loss_distill")]:
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want)), (got, want)
    worst = max(rel_peak(to_jax_layout(g, n), leaf(jg, n)) for n, g in pg.items())
    print(f"distill={distill}: worst gradient leaf {worst:.2e} of its peak")
    assert worst <= GRAD_TOL
    # two steps: parameters, moments, Adam's count and the step
    jstep = jax.jit(jet.make_train_step(cfg, distill))
    for k in jax.random.split(key):
        st, jmet = jstep(st, jnp.asarray(wave), jnp.asarray(f0), jnp.asarray(teacher), k)
        pmet = step(ps, *args, np.asarray(k))
        assert abs(float(pmet["loss"]) - float(jmet["loss"])) <= LOSS_RTOL * abs(float(jmet["loss"]))
    st = jax.device_get(st)
    adam = st.opt_state[1][0]
    assert ps.step == int(st.step) == 2 and ps.opt.count == int(adam.count) == 2
    for n, p in ps.encoder.named_parameters():
        assert np.abs(to_jax_layout(p, n) - leaf(st.params, n)).max() <= PARAM_ATOL, n
        assert rel_peak(to_jax_layout(ps.opt.mu[n], n), leaf(adam.mu, n)) <= MOMENT_TOL, n
        assert rel_peak(to_jax_layout(ps.opt.nu[n], n), leaf(adam.nu, n)) <= MOMENT_TOL, n


def test_pitch_only_step_decays_the_content_head(rng):
    """Without a teacher the content head's gradient is exactly 0, yet AdamW
    decays it: ``p + (1e-4 p) (-lr)`` bit for bit here, and JAX's moves so."""
    cfg, pc = small_config(), port_config()
    wave, f0, _ = batch(rng)
    st = jax_state(cfg)
    ps = encoder_train_state_from_jax(jax.device_get(st), pc.encoder)
    before = {n: p.detach().clone() for n, p in ps.encoder.named_parameters()}
    step = pet.make_train_step(pc, distill=False)
    _, _, grads = step.loss_and_grads(ps, torch.from_numpy(wave), torch.from_numpy(f0), None,
                                      np.asarray(jax.random.PRNGKey(3)))
    ssl = [n for n in grads if n.startswith("ssl_feature_estimator.")]
    assert ssl and all(torch.count_nonzero(grads[n]) == 0 for n in ssl)
    assert any(torch.count_nonzero(grads[n]) for n in grads if n not in ssl)
    step(ps, torch.from_numpy(wave), torch.from_numpy(f0), None,
         np.asarray(jax.random.PRNGKey(3)))
    jst, _ = jax.jit(jet.make_train_step(cfg, distill=False))(
        st, jnp.asarray(wave), jnp.asarray(f0), jnp.zeros((B, 1, 32)), jax.random.PRNGKey(3))
    lr = pc.train.learning_rate
    for n in ssl:
        p = dict(ps.encoder.named_parameters())[n].detach()
        decayed = before[n] + (WEIGHT_DECAY * before[n]) * (-lr)
        assert torch.equal(p, decayed), n
        np.testing.assert_allclose(leaf(jax.device_get(jst.params), n), to_jax_layout(p, n),
                                   rtol=1e-7, atol=1e-12)
