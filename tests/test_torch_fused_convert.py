"""The whole conversion slice with the fused U-Net (``use_fused_filter="on"``
on both sides, explicit noise angle) against `tinyvc_tpu`'s ``convert_fn``,
whose Pallas kernels run in interpret mode on the CPU: at small widths with
random weights, and at full width with the committed two-speaker weights on
a 1 s crop of the demo utterance. Also which U-Net each flag value picks."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models import Decoder, Encoder
from tinyvc_tpu.utils.model_store import _load_params_npz
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.dsp.padding import pad_to_bucket
from tinyvc_tpu_torch.infer.generator import convert_fn, decode_infer, exact_fp32
from tinyvc_tpu_torch.kernels import filter_stage
from tinyvc_tpu_torch.models.decoder import pack_source
from tinyvc_tpu_torch.ops.fused_filternet import filternet_fused_apply
from tinyvc_tpu_torch.utils.audio_io import load_audio
from tinyvc_tpu_torch.utils.model_store import load_index
from tinyvc_tpu_torch.utils.weights import decoder_from_jax, encoder_from_jax, load_npz
from torch_parity import jax_stages, random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models", "two_speaker")
ENC = dict(pitch_channels=16, pitch_num_layers=2, ssl_channels=24, ssl_dilations=(1, 3),
           ssl_dim=32)
DEC = dict(num_harmonics=4, source_channels=16, source_num_layers=2,
           filter_channels=(32, 16, 8, 8, 8), content_channels=32)


def _port_convert(enc_p, dec_p, wave, target, pitch, angle, cfg):
    with torch.inference_mode(), exact_fp32():
        out = convert_fn(encoder_from_jax(enc_p, cfg.encoder),
                         decoder_from_jax(dec_p, cfg.decoder, cfg.audio),
                         torch.from_numpy(wave), torch.from_numpy(target), pitch, 0, cfg,
                         noise_angle=torch.from_numpy(angle))
    return out.numpy()


def _small(rng, F):
    jc = jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC),
                           decoder=jcfg.DecoderConfig(**DEC, use_fused_filter="on"))
    E, D = Encoder(jc.encoder), Decoder(jc.decoder, jc.audio)
    L = F * 480
    enc_p = random_params(E, jnp.zeros((1, F, 961)))
    # steer the random pitch head to ~150 Hz, as tests/test_torch_convert.py does
    head = enc_p["params"]["pitch_estimator"]["stack"]["output_layer"]
    head["bias"] = head["bias"] + 8.0 * np.exp(-(((np.arange(512) - 140) / 20.0) ** 2))
    dec_p = random_params(D, jnp.zeros((1, F, 32)), jnp.full((1, F), 100.0), jnp.zeros((1, L)),
                          jnp.zeros((2,), jnp.uint32), noise_angle=jnp.zeros((1, F, 961)))
    return jc, E, D, enc_p, dec_p


def test_convert_fused_small_widths(rng):
    F = 16
    jc, E, D, enc_p, dec_p = _small(rng, F)
    t = np.arange(F * 480) / 24000
    wave = (0.3 * np.sin(2 * np.pi * rng.uniform(90, 250, (2, 1)) * t)
            + 0.02 * rng.standard_normal((2, F * 480))).astype(np.float32)
    target = rng.standard_normal((60, 32)).astype(np.float32)
    angle = rng.uniform(-math.pi, math.pi, (2, F, 961)).astype(np.float32)
    want = jax_stages(E, D, enc_p, dec_p, wave, target, 5.0, angle, jc)["wave"]
    pc = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC),
                           decoder=pcfg.DecoderConfig(**DEC, use_fused_filter="on"))
    got = _port_convert(enc_p, dec_p, wave, target, 5.0, angle, pc)
    assert got.shape == want.shape
    # the harmonics' cumsum order (XLA's parallel prefix against torch's
    # sequential sum) drifts the phase with time and carries into the
    # waveform: on these inputs both U-Nets, fused and layer by layer, end
    # 4.0e-5 (1.1e-4 of the peak) from JAX in the last frame; 2e-4 of the
    # peak. The U-Net alone is held to 1e-5 of the peak in
    # tests/test_torch_filter_stage.py.
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_convert_fused_two_speaker_matches_jax(rng):
    cfg = jcfg.TinyVCConfig(decoder=jcfg.DecoderConfig(use_fused_filter="on"))
    wave, _ = pad_to_bucket(load_audio(os.path.join(ROOT, "demo", "two_speaker",
                                                    "source_A.wav"))[0][:, :24000])
    F = wave.shape[1] // 480
    angle = rng.uniform(-np.pi, np.pi, (1, F, 961)).astype(np.float32)
    index = load_index(os.path.join(MODELS, "index_B.npy"))
    want = jax_stages(Encoder(cfg.encoder), Decoder(cfg.decoder, cfg.audio),
                      _load_params_npz(os.path.join(MODELS, "encoder_B.npz")),
                      _load_params_npz(os.path.join(MODELS, "decoder_B.npz")),
                      wave, index, chip_smoke.PITCH_SHIFT, angle, cfg)["wave"]
    pc = pcfg.TinyVCConfig(decoder=pcfg.DecoderConfig(use_fused_filter="on"))
    got = _port_convert(load_npz(os.path.join(MODELS, "encoder_B.npz")),
                        load_npz(os.path.join(MODELS, "decoder_B.npz")),
                        wave, index, chip_smoke.PITCH_SHIFT, angle, pc)
    assert got.shape == want.shape == (1, wave.shape[1])
    np.testing.assert_allclose(got, want, atol=chip_smoke.WAVE_ATOL)
    # what this CPU comparison shows: the same 2e-5 as the layer-by-layer
    # path in tests/test_torch_two_speaker.py
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_flag_picks_the_unet(rng):
    """On CPU tensors "auto" runs the layer-by-layer U-Net and "on" the fused
    one (plain versions, no kernel launch); the two differ near the ends."""
    F = 8
    jc, E, D, enc_p, dec_p = _small(rng, F)
    dec = decoder_from_jax(dec_p, pcfg.DecoderConfig(**DEC))
    content = torch.from_numpy(rng.standard_normal((1, F, 32)).astype(np.float32))
    f0 = torch.full((1, F), 150.0)
    energy = torch.from_numpy(0.1 * np.abs(rng.standard_normal((1, F * 480))).astype(np.float32))
    angle = torch.from_numpy(rng.uniform(-np.pi, np.pi, (1, F, 961)).astype(np.float32))

    def run(flag):
        cfg = pcfg.TinyVCConfig(decoder=pcfg.DecoderConfig(**DEC, use_fused_filter=flag))
        with torch.inference_mode():
            return decode_infer(dec, content, f0, energy, 0, cfg, angle)

    before = filter_stage.upsample_chain.launches
    auto, on, off = run("auto"), run("on"), run("off")
    with torch.inference_mode():
        layered = dec.infer(content, f0, energy, 0, angle)
        src = pack_source(*dec.dsp_parts(f0, *dec.source_net(content, f0, energy), 0, angle),
                          energy)
        fused = filternet_fused_apply(dec.filter_net, pcfg.DecoderConfig(**DEC), content, f0,
                                      energy, src)
    assert src.shape == (1, 8, F * 480)
    np.testing.assert_array_equal(src[:, 6].numpy(), energy.numpy())  # the packed energy row
    np.testing.assert_array_equal(src[:, 7].numpy(), 0.0)
    np.testing.assert_array_equal(auto.numpy(), layered.numpy())
    np.testing.assert_array_equal(off.numpy(), layered.numpy())
    np.testing.assert_array_equal(on.numpy(), fused.numpy())
    assert not np.array_equal(on.numpy(), off.numpy())  # edge replication differs
    assert filter_stage.upsample_chain.launches == before
    with pytest.raises(ValueError, match="use_fused_filter"):
        run("maybe")
