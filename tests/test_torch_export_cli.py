"""The port's last CLIs on the CPU at the tests' ``small_config`` widths:
`cli/export_params.py` on checkpoint directories that the port's trainers
write (the ``.npz`` loads in the JAX package with JAX's tree, bit-equal to
the checkpoint, and JAX's decoder on it equals the port's); the web UI's
conversion (`cli/infer_webui.py::svc`) on a stereo 48 kHz int16 input
against JAX's steps on JAX's ``VoiceConverter``; and the exits of the
gated CLIs where gradio or PyAudio is missing."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.dsp.resample import resample as j_resample
from tinyvc_tpu.infer.generator import VoiceConverter as JVoiceConverter
from tinyvc_tpu.models import Decoder as JDecoder
from tinyvc_tpu.models import Encoder as JEncoder
from tinyvc_tpu.train import decoder_train as jdt
from tinyvc_tpu.train import encoder_train as jet
from tinyvc_tpu.utils.model_store import _load_params_npz
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.cli import audio_device_list as cli_devices
from tinyvc_tpu_torch.cli import export_params as cli_export_params
from tinyvc_tpu_torch.cli import infer_webui as cli_webui
from tinyvc_tpu_torch.infer.generator import VoiceConverter
from tinyvc_tpu_torch.train import decoder_train as pdt
from tinyvc_tpu_torch.train import encoder_train as pet
from tinyvc_tpu_torch.utils.checkpoint import CheckpointManager
from tinyvc_tpu_torch.utils.model_store import load_decoder_params
from tinyvc_tpu_torch.utils.weights import decoder_from_jax
from torch_parity import numpy_params

# the widths of tests/test_training.py::small_config
ENC = dict(pitch_channels=16, pitch_num_layers=1, ssl_channels=16, ssl_dilations=(1,),
           ssl_dim=32)
DEC = dict(source_channels=16, source_num_layers=1, filter_channels=(32, 24, 16, 12, 8),
           content_channels=32)
# tests/test_torch_cli.py: one step of int16(x * 32767) read as / 32768
PCM_ATOL = 2.0 / 32767


def _configs():
    return (jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC),
                              decoder=jcfg.DecoderConfig(**DEC)),
            pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC),
                              decoder=pcfg.DecoderConfig(**DEC)))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Encoder and decoder checkpoint directories of the trainers' writer,
    from fresh train states (the discriminator's entries beside the
    generator's) -> (encoder dir, decoder dir)."""
    _, pc = _configs()
    tmp = tmp_path_factory.mktemp("ckpt")
    CheckpointManager(str(tmp / "enc")).save(3, pet.init_state(pc, 1, "cpu"), pc)
    CheckpointManager(str(tmp / "dec")).save(5, pdt.init_state(pc, 2, "cpu"), pc)
    return str(tmp / "enc"), str(tmp / "dec")


def test_export_params_gives_the_jax_package_its_tree(checkpoints, tmp_path, capsys):
    enc_dir, dec_dir = checkpoints
    enc_npz, dec_npz = str(tmp_path / "e.npz"), str(tmp_path / "d.npz")
    cli_export_params.main(["-encp", enc_dir, "-decp", dec_dir, "-o-enc", enc_npz,
                            "-o-dec", dec_npz])
    assert capsys.readouterr().out.splitlines() == [
        f"encoder params -> {enc_npz}", f"decoder generator params -> {dec_npz}"]
    jc, _ = _configs()
    key = jax.random.PRNGKey(0)
    trees = {
        "params/": (enc_dir, 3, enc_npz,
                    jax.eval_shape(lambda k: jet.init_state(jc, k)[1].params, key)),
        "gen_params/params/": (dec_dir, 5, dec_npz,
                               jax.eval_shape(lambda k: jdt.init_state(jc, k).gen_params, key)),
    }
    for prefix, (directory, step, npz, want) in trees.items():
        got = _flat(_load_params_npz(npz))
        shapes = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in _flat(want).items()}
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == shapes
        state = torch.load(os.path.join(directory, str(step), "state.pt"), weights_only=False)
        saved = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        assert sorted(saved) == sorted(k[len("params/"):] for k in got)
        for k, v in saved.items():
            np.testing.assert_array_equal(got["params/" + k], v, err_msg=k)


def test_jax_decoder_on_exported_params_matches_the_port(checkpoints, tmp_path):
    _, dec_dir = checkpoints
    npz = str(tmp_path / "d.npz")
    cli_export_params.main(["-decp", dec_dir, "-o-dec", npz])
    jc, pc = _configs()
    jd = JDecoder(jc.decoder, jc.audio)
    port = decoder_from_jax(load_decoder_params(dec_dir), pc.decoder, pc.audio)
    params = _load_params_npz(npz)
    rng = np.random.default_rng(0)
    B, F = 2, 6
    L = F * 480
    content = rng.standard_normal((B, F, 32)).astype(np.float32)
    f0 = rng.uniform(60.0, 300.0, (B, F)).astype(np.float32)
    energy = rng.uniform(0.0, 0.5, (B, L)).astype(np.float32)
    source = (0.3 * rng.standard_normal((B, 16, L))).astype(np.float32)
    want = jax.jit(lambda p, c, f, e, s: (
        jd.apply(p, c, f, e, method=lambda m, c, f, e: m.source_net(c, f, e)),
        jd.apply(p, c, f, e, s, method=lambda m, c, f, e, s: m.filter_net(
            c, f, e, s, source_channels_first=True))))(params, content, f0, energy, source)
    with torch.inference_mode():
        t = [torch.from_numpy(a) for a in (content, f0, energy, source)]
        got = (port.source_net(*t[:3]), port.filter_net(*t))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max())


def test_export_params_refuses_nothing_and_orbax_directories(tmp_path):
    with pytest.raises(SystemExit, match="nothing to export: pass -encp and/or -decp"):
        cli_export_params.main([])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax checkpoint directories need orbax and JAX"):
        cli_export_params.main(["-encp", str(tmp_path / "orbax")])


@pytest.mark.parametrize("cli,package", ((cli_webui, "gradio"), (cli_devices, "pyaudio")))
def test_gated_clis_exit_with_jax_messages(monkeypatch, cli, package):
    """Blocked imports raise ImportError; the web UI exits before it reads a
    model (the paths do not exist)."""
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(SystemExit, match=f"{package} is not installed in this environment"):
        cli.main(["-encp", "missing", "-decp", "missing"] if cli is cli_webui else [])


def _stereo_48k_int16(rng, seconds, f):
    t = np.arange(int(48000 * seconds)) / 48000
    w = 0.3 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(4 * np.pi * f * t)
    w = w + 0.02 * rng.standard_normal(t.shape)
    return 48000, (np.stack([w, 0.7 * w], axis=1) * 20000).astype(np.int16)


def test_webui_svc_follows_jax_steps(rng):
    jc, pc = _configs()
    enc_p = numpy_params(JEncoder(jc.encoder), jnp.zeros((1, 8, 961)))
    # random weights decode f0 in the kHz; push the pitch head towards class
    # 140 (~150 Hz), a voice's (tests/test_torch_convert.py)
    head = enc_p["params"]["pitch_estimator"]["stack"]["output_layer"]
    head["bias"] = head["bias"] + 8.0 * np.exp(-(((np.arange(512) - 140) / 20.0) ** 2))
    dec_p = numpy_params(JDecoder(jc.decoder, jc.audio), jnp.zeros((1, 8, 32)),
                         jnp.full((1, 8), 100.0), jnp.zeros((1, 8 * 480)),
                         jax.random.PRNGKey(0), noise_angle=jnp.zeros((1, 8, 961)), seed=8)
    # JAX on the CPU draws the noise phases from jax.random (its XLA branch),
    # the port hashes them as JAX's TPU kernel does (the seed contract,
    # tests/test_torch_prng.py): a zero noise filter (elu(-1e4) + 1 = 0)
    # takes the noise out of both, and the comparison holds the rest
    dec_p["params"]["source_net"]["to_kernel"]["bias"][:] = -1e4
    source, target = _stereo_48k_int16(rng, 0.6, 140.0), _stereo_48k_int16(rng, 0.8, 210.0)

    # JAX's infer_webui.py:37-54, written out on JAX's VoiceConverter
    def jax_wave(audio):
        sr, wf = audio
        wf = np.asarray(wf, dtype=np.float32).sum(axis=1)
        wf = wf / (np.abs(wf).max() + 1e-9)
        return np.asarray(j_resample(jnp.asarray(wf[None]), sr, 24000))[0]

    jvc = JVoiceConverter(enc_p, dec_p, jc)
    out = jvc.convert(jax_wave(source), jvc.build_dictionary(jax_wave(target)), 4.0)
    want = (np.clip(out, -1.0, 1.0) * 32768.0).astype(np.int16)

    vc = VoiceConverter(enc_p, dec_p, pc, device="cpu")
    sr, got = cli_webui.svc(vc, pc, source, target, 4.0)
    assert sr == 24000 and got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(want).max() > 3000  # a voice, not silence
    np.testing.assert_allclose(got / 32768.0, want / 32768.0, atol=PCM_ATOL, rtol=0)
