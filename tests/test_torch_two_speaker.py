"""The port's conversion with the committed two-speaker weights at full
width (`models/two_speaker/`), against `tinyvc_tpu`'s ``convert_fn``
(``use_fused_filter="off"``, explicit noise angle) on a 1 s crop of the demo
utterance, stage by stage; and the port's whole 6 s output measured against
the JAX package's converted rendition, which sets `chip_smoke.py`'s bound."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from tinyvc_tpu.config import DecoderConfig, TinyVCConfig
from tinyvc_tpu.models import Decoder, Encoder
from tinyvc_tpu.utils.model_store import _load_params_npz
from tinyvc_tpu_torch.config import TinyVCConfig as PortConfig
from tinyvc_tpu_torch.dsp.mel import log_mel_l1
from tinyvc_tpu_torch.dsp.padding import pad_to_bucket
from tinyvc_tpu_torch.infer.generator import VoiceConverter, convert_fn, exact_fp32
from tinyvc_tpu_torch.utils.audio_io import load_audio
from tinyvc_tpu_torch.utils.model_store import load_index
from tinyvc_tpu_torch.utils.weights import decoder_from_jax, encoder_from_jax, load_npz
from torch_parity import jax_stages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models", "two_speaker")
DEMO = os.path.join(ROOT, "demo", "two_speaker")


@pytest.fixture(scope="module")
def weights():
    return (load_npz(os.path.join(MODELS, "encoder_B.npz")),
            load_npz(os.path.join(MODELS, "decoder_B.npz")),
            load_index(os.path.join(MODELS, "index_B.npy")))


def test_real_weights_match_jax_stage_by_stage(weights, rng):
    enc_p, dec_p, index = weights
    cfg = TinyVCConfig(decoder=DecoderConfig(use_fused_filter="off"))
    wave, _ = pad_to_bucket(load_audio(os.path.join(DEMO, "source_A.wav"))[0][:, :24000])
    F = wave.shape[1] // 480
    angle = rng.uniform(-np.pi, np.pi, (1, F, 961)).astype(np.float32)
    E, D = Encoder(cfg.encoder), Decoder(cfg.decoder, cfg.audio)
    # the JAX side reads the npz through its own loader
    want = jax_stages(E, D, _load_params_npz(os.path.join(MODELS, "encoder_B.npz")),
                      _load_params_npz(os.path.join(MODELS, "decoder_B.npz")),
                      wave, index, chip_smoke.PITCH_SHIFT, angle, cfg)

    got = {}
    with torch.inference_mode(), exact_fp32():
        out = convert_fn(encoder_from_jax(enc_p), decoder_from_jax(dec_p),
                         torch.from_numpy(wave), torch.from_numpy(index),
                         chip_smoke.PITCH_SHIFT, 0, PortConfig(),
                         noise_angle=torch.from_numpy(angle), stages=got)
    got = {k: v.numpy() for k, v in got.items()}
    got["wave"] = out.numpy()

    def close(name, atol, rtol=0.0):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=rtol, err_msg=name)

    close("spec", 1e-5 * np.abs(want["spec"]).max())  # fp32 FFTs of two libraries
    close("content", 1e-4 * np.abs(want["content"]).max())  # fp32 reduction order
    close("f0", 0.0, rtol=1e-5)  # softmax-weighted class frequencies, pitch-shifted
    # the kNN picks the same dictionary frames: the mean is bit-identical
    np.testing.assert_array_equal(got["matched"], want["matched"])
    close("energy", 1e-6)
    close("source", 1e-4)  # cumsum order (parallel prefix vs sequential), ~2e-6 cycles
    assert got["wave"].shape == (1, wave.shape[1])
    close("wave", chip_smoke.WAVE_ATOL)
    close("wave", 1e-4)  # what this CPU comparison shows (2e-5 measured)


def test_full_utterance_log_mel_against_demo(weights):
    enc_p, dec_p, index = weights
    source = load_audio(os.path.join(DEMO, "source_A.wav"))[0][0]
    vc = VoiceConverter(enc_p, dec_p, device="cpu")
    out = vc.convert(source, index, chip_smoke.PITCH_SHIFT, seed=chip_smoke.SEED)
    assert out.shape == source.shape and np.isfinite(out).all()
    ref = torch.from_numpy(load_audio(os.path.join(DEMO, "converted_A_to_B.wav"))[0][0])
    mel_conv = log_mel_l1(torch.from_numpy(out), ref)
    mel_src = log_mel_l1(torch.from_numpy(out), torch.from_numpy(source))
    # measured on the CPU: 0.2426 against the JAX rendition (the TPU's fused
    # path; seed 0 now draws the noise of its default PRNGKey(0), where the
    # port's own hash seed 0 gave 0.3538), 2.457 against the source
    assert mel_conv < chip_smoke.MEL_L1_BOUND, mel_conv
    assert abs(mel_conv - 0.2426) < 0.01, mel_conv
    assert mel_src > 2.0, mel_src
