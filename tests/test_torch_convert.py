"""The whole conversion slice of the port against `tinyvc_tpu`'s
``convert_fn`` (``use_fused_filter="off"``, explicit noise angle) at small
widths with random weights, stage by stage."""

import math

import jax.numpy as jnp
import numpy as np
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models import Decoder, Encoder
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.infer.generator import convert_fn, exact_fp32
from tinyvc_tpu_torch.utils.weights import decoder_from_jax, encoder_from_jax
from torch_parity import jax_stages, random_params

ENC = dict(pitch_channels=16, pitch_num_layers=2, ssl_channels=24, ssl_dilations=(1, 3),
           ssl_dim=32)
DEC = dict(num_harmonics=4, source_channels=16, source_num_layers=2,
           filter_channels=(32, 16, 8, 8, 8), content_channels=32)


def _voiced(rng, B, L, sr=24000):
    t = np.arange(L) / sr
    f = rng.uniform(90, 250, (B, 1))
    w = 0.3 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(4 * np.pi * f * t)
    return (w + 0.02 * rng.standard_normal((B, L))).astype(np.float32)


def test_convert_small_widths(rng):
    jc = jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC),
                           decoder=jcfg.DecoderConfig(**DEC, use_fused_filter="off"))
    pc = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC), decoder=pcfg.DecoderConfig(**DEC))
    E, D = Encoder(jc.encoder), Decoder(jc.decoder, jc.audio)
    F = 16
    L = F * 480
    enc_p = random_params(E, jnp.zeros((1, F, 961)))
    # random weights decode f0 in the kHz; push the pitch head towards class
    # 140 (~150 Hz) so that f0 is a voice's: the harmonics' fp32 phase
    # rounding, and so the tolerances below, scale with f0
    head = enc_p["params"]["pitch_estimator"]["stack"]["output_layer"]
    head["bias"] = head["bias"] + 8.0 * np.exp(-(((np.arange(512) - 140) / 20.0) ** 2))
    dec_p = random_params(D, jnp.zeros((1, F, 32)), jnp.full((1, F), 100.0), jnp.zeros((1, L)),
                          jnp.zeros((2,), jnp.uint32), noise_angle=jnp.zeros((1, F, 961)))
    wave = _voiced(rng, 2, L)
    target = rng.standard_normal((60, 32)).astype(np.float32)
    angle = rng.uniform(-math.pi, math.pi, (2, F, 961)).astype(np.float32)
    want = jax_stages(E, D, enc_p, dec_p, wave, target, 5.0, angle, jc)
    assert 100.0 < np.median(want["f0"]) < 500.0

    got = {}
    with torch.inference_mode(), exact_fp32():
        out = convert_fn(encoder_from_jax(enc_p, pc.encoder),
                         decoder_from_jax(dec_p, pc.decoder, pc.audio),
                         torch.from_numpy(wave), torch.from_numpy(target), 5.0, 0, pc,
                         noise_angle=torch.from_numpy(angle), stages=got)
    got = {k: v.numpy() for k, v in got.items()}
    got["wave"] = out.numpy()

    def close(name, atol, rtol=0.0):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=rtol, err_msg=name)

    # fp32 FFTs from two libraries: 1e-5 of the spectrum's peak
    close("spec", 1e-5 * np.abs(want["spec"]).max())
    # fp32 matmul/reduction order through the ConvNeXt stacks
    close("content", 1e-4 * np.abs(want["content"]).max())
    close("f0", 1e-3, rtol=1e-4)
    # identical neighbours: only the fp32 mean differs
    close("matched", 1e-6)
    close("energy", 1e-6)
    # harmonics: XLA's parallel-prefix cumsum against torch's sequential one
    # (~2e-6 cycles, times harmonic 5 and the amplitude); noise row: fp32 istft
    close("source", 2e-4 * float(want["amps"].max()))
    close("wave", 1e-4 * np.abs(want["wave"]).max())
