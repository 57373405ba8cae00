"""Modules of the port (`tinyvc_tpu_torch`) against their JAX counterparts on
the same numpy inputs, at small widths, with random weights carried across by
`utils/weights.py`."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.dsp.energy import estimate_energy as j_estimate_energy
from tinyvc_tpu.dsp.pitch import shift_frequency as j_shift_frequency
from tinyvc_tpu.dsp.stft import istft as j_istft
from tinyvc_tpu.dsp.stft import spectrogram as j_spectrogram
from tinyvc_tpu.dsp.interp import downsample_time_int_t as j_down
from tinyvc_tpu.dsp.interp import upsample_time_int_t as j_up
from tinyvc_tpu.dsp.padding import pad_to_bucket as j_pad_to_bucket
from tinyvc_tpu.models import decoder as j_decoder
from tinyvc_tpu.models import encoder as j_encoder
from tinyvc_tpu.ops import retrieval as j_retrieval
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.dsp import energy, interp, padding, pitch, stft
from tinyvc_tpu_torch.ops import retrieval
from tinyvc_tpu_torch.utils.weights import decoder_from_jax, encoder_from_jax, state_dict_from_jax
from torch_parity import random_params

ENC = dict(pitch_channels=16, pitch_num_layers=2, ssl_channels=24, ssl_dilations=(1, 3),
           ssl_dim=32)
DEC = dict(num_harmonics=4, source_channels=16, source_num_layers=2,
           filter_channels=(32, 16, 8, 8, 8), content_channels=32)


def _t(x):
    return torch.tensor(np.asarray(x))


def test_spectrogram_and_istft(rng):
    wave = rng.standard_normal((2, 480 * 12)).astype(np.float32)
    want = np.asarray(j_spectrogram(jnp.asarray(wave)))
    got = stft.spectrogram(_t(wave)).numpy()
    assert got.shape == want.shape == (2, 12, 961)
    # 1e-4 relative to the peak: two fp32 FFT libraries (pocketfft vs ducc)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    spec = rng.standard_normal((2, 9, 961)) + 1j * rng.standard_normal((2, 9, 961))
    want = np.asarray(j_istft(jnp.asarray(spec.astype(np.complex64)), 1920, 480))
    got = stft.istft(_t(spec.astype(np.complex64)), 1920, 480).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)  # fp32 irfft + overlap-add order


def test_dsp_helpers(rng):
    wave = rng.standard_normal((2, 480 * 64)).astype(np.float32)
    # energy: max-pool then the x64 upsample (kernel C's plain version)
    np.testing.assert_allclose(
        energy.estimate_energy(_t(wave), 64).numpy(),
        np.asarray(j_estimate_energy(jnp.asarray(wave), 64)), atol=1e-6)
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    for f in (2, 3, 4, 5):
        # 1e-6: a two-tap fp32 sum against XLA's dilated conv
        np.testing.assert_allclose(interp.upsample_time_int_t(_t(x), f).numpy(),
                                   np.asarray(j_up(jnp.asarray(x), f)), atol=1e-6)
        np.testing.assert_allclose(interp.downsample_time_int_t(_t(x), f).numpy(),
                                   np.asarray(j_down(jnp.asarray(x), f)), atol=1e-6)
    f0 = np.abs(rng.standard_normal((2, 30)) * 200).astype(np.float32)
    f0[0, :5] = 0.0
    np.testing.assert_allclose(pitch.shift_frequency(_t(f0), 11.99).numpy(),
                               np.asarray(j_shift_frequency(jnp.asarray(f0), 11.99)),
                               rtol=1e-5, atol=1e-6)  # fp32 log2/exp2
    # bucket padding: exactly the JAX package's (GRN sees the padding)
    w = rng.standard_normal((1, 144000)).astype(np.float32)
    got, L = padding.pad_to_bucket(w)
    want, L2 = j_pad_to_bucket(w)
    assert L == L2 == 144000 and got.shape == want.shape == (1, 153600)
    np.testing.assert_array_equal(got, want)


def test_weight_transfer_round_trip(rng):
    cfg = jcfg.EncoderConfig(**ENC)
    enc = j_encoder.Encoder(cfg)
    params = random_params(enc, jnp.zeros((1, 8, 961)))
    sd = state_dict_from_jax(params)
    k = np.asarray(params["params"]["ssl_feature_estimator"]["stack"]["layer_1"]["dw"]["kernel"])
    assert sd["ssl_feature_estimator.stack.layer_1.dw.weight"].shape == (24, 1, 7)
    np.testing.assert_array_equal(
        sd["ssl_feature_estimator.stack.layer_1.dw.weight"].numpy(), np.transpose(k, (2, 1, 0)))
    model = encoder_from_jax(params, pcfg.EncoderConfig(**ENC))
    assert set(model.state_dict()) == set(sd)


def test_encoder_infer(rng):
    cfg = jcfg.EncoderConfig(**ENC)
    enc = j_encoder.Encoder(cfg)
    spec = np.abs(rng.standard_normal((2, 24, 961))).astype(np.float32)
    params = random_params(enc, jnp.zeros((1, 8, 961)))
    want_c, want_f0 = jax.jit(lambda p, x: enc.apply(p, x, method=enc.infer))(params, spec)
    got_c, got_f0 = encoder_from_jax(params, pcfg.EncoderConfig(**ENC)).infer(_t(spec))
    # fp32 matmul and reduction order: 1e-4 relative to the feature scale;
    # f0 is a softmax-weighted mean of class frequencies (rtol 1e-4)
    np.testing.assert_allclose(got_c.detach().numpy(), np.asarray(want_c),
                               atol=1e-4 * np.abs(np.asarray(want_c)).max())
    np.testing.assert_allclose(got_f0.detach().numpy(), np.asarray(want_f0), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("metric", ["cos", "IP", "L2"])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_match_features(rng, metric, alpha):
    src = rng.standard_normal((2, 20, 16)).astype(np.float32)
    ref = rng.standard_normal((40, 16)).astype(np.float32)
    want = np.asarray(j_retrieval.match_features(
        jnp.asarray(src), jnp.broadcast_to(jnp.asarray(ref)[None], (2, 40, 16)),
        k=4, alpha=alpha, metric=metric))
    got = retrieval.match_features(_t(src), _t(ref), k=4, alpha=alpha, metric=metric).numpy()
    # same neighbours, so only the fp32 mean and blend differ
    np.testing.assert_allclose(got, want, atol=1e-6)
    got3 = retrieval.match_features(_t(src), _t(np.stack([ref, ref])), k=4, alpha=alpha,
                                    metric=metric).numpy()
    np.testing.assert_allclose(got3, want, atol=1e-6)


def test_top_k_ties_go_to_lowest_index():
    sims = np.array([[3.0, 5.0, 5.0, 1.0, 5.0, 3.0, 0.0]], np.float32)
    want_v, want_i = j_retrieval.top_k_small(jnp.asarray(sims), 4)
    got_v, got_i = retrieval.top_k_small(_t(sims), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), [[1, 2, 4, 0]])
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _decoder_pair(rng):
    jc = jcfg.DecoderConfig(**DEC, use_fused_filter="off")
    dec = j_decoder.Decoder(jc, jcfg.AudioConfig())
    F, L = 8, 8 * 480
    params = random_params(dec, jnp.zeros((1, F, 32)), jnp.full((1, F), 100.0),
                           jnp.zeros((1, L)), jax.random.PRNGKey(0),
                           noise_angle=jnp.zeros((1, F, 961)))
    return dec, params, decoder_from_jax(params, pcfg.DecoderConfig(**DEC))


def test_source_net_and_dsp(rng):
    dec, params, port = _decoder_pair(rng)
    B, F = 2, 10
    content = rng.standard_normal((B, F, 32)).astype(np.float32)
    f0 = rng.uniform(60, 300, (B, F)).astype(np.float32)
    f0[1, :3] = 0.0
    energy_w = rng.uniform(0, 0.5, (B, F * 480)).astype(np.float32)
    ang = rng.uniform(-math.pi, math.pi, (B, F, 961)).astype(np.float32)
    amps, kern = jax.jit(lambda p, c, f, e: dec.apply(
        p, c, f, e, method=lambda m, c, f, e: m.source_net(c, f, e)))(params, content, f0, energy_w)
    got_a, got_k = port.source_net(_t(content), _t(f0), _t(energy_w))
    # ConvNeXt trunk in fp32: 1e-4 relative
    np.testing.assert_allclose(got_a.detach().numpy(), np.asarray(amps), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_k.detach().numpy(), np.asarray(kern), rtol=1e-4, atol=1e-5)
    src = jax.jit(lambda p, f, a, k, na: dec.apply(
        p, f, a, k, jax.random.PRNGKey(0), na,
        method=lambda m, f, a, k, key, na: m.dsp(f, a, k, key, noise_angle=na,
                                                 channels_first=True)))(params, f0, amps, kern, ang)
    got = port.dsp(_t(f0), _t(np.asarray(amps)), _t(np.asarray(kern)), 0, _t(ang)).numpy()
    assert got.shape == (B, DEC["num_harmonics"] + 2, F * 480)
    src = np.asarray(src)
    # the same two-level mod-1 phase scheme, but XLA's cumsum is a parallel
    # prefix and torch's is sequential: ~2e-6 cycles of phase rounding, times
    # harmonic 5, times the amplitude
    np.testing.assert_allclose(got[:, :-1], src[:, :-1], atol=2e-4 * float(np.max(amps)))
    np.testing.assert_allclose(got[:, -1], src[:, -1], atol=1e-6)  # noise: fp32 istft


def test_filter_net(rng):
    dec, params, port = _decoder_pair(rng)
    B, F = 2, 6
    L = F * 480
    content = rng.standard_normal((B, F, 32)).astype(np.float32)
    f0 = rng.uniform(60, 300, (B, F)).astype(np.float32)
    energy_w = rng.uniform(0, 0.5, (B, L)).astype(np.float32)
    source = rng.standard_normal((B, DEC["num_harmonics"] + 2, L)).astype(np.float32) * 0.3
    want = jax.jit(lambda p, c, f, e, s: dec.apply(
        p, c, f, e, s, method=lambda m, c, f, e, s: m.filter_net(
            c, f, e, s, source_channels_first=True)))(params, content, f0, energy_w, source)
    got = port.filter_net(_t(content), _t(f0), _t(energy_w), _t(source)).detach().numpy()
    assert got.shape == (B, L)
    want = np.asarray(want)
    # ten conv stages in fp32: 1e-4 relative to the output's peak
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())

    # the whole decoder, source included (explicit noise angle)
    ang = rng.uniform(-math.pi, math.pi, (B, F, 961)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, c, f, e, a: dec.apply(
        p, c, f, e, jax.random.PRNGKey(0), noise_angle=a, method=dec.infer))(
            params, content, f0, energy_w, ang))
    got = port.infer(_t(content), _t(f0), _t(energy_w), 0, _t(ang)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
