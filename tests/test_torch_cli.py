"""The port's conversion CLIs on the CPU at full width with the two-speaker
weights: `cli/infer.py` on a 48 kHz stereo WAV with reference ``.pt``
weights and a target encoded from another 48 kHz file, its chunked
conversion (``-c``), and `cli/infer_streaming.py`'s file mode with gains and
pipelined dispatch."""

import os

import numpy as np
import pytest
import torch

from test_torch_model_store import decoder_state_dict, encoder_state_dict
from tinyvc_tpu_torch.cli import infer as cli_infer
from tinyvc_tpu_torch.cli import infer_streaming as cli_stream
from tinyvc_tpu_torch.dsp.resample import resample
from tinyvc_tpu_torch.infer.generator import VoiceConverter
from tinyvc_tpu_torch.infer.stream import StreamConverter
from tinyvc_tpu_torch.utils.audio_io import load_audio, save_wav
from tinyvc_tpu_torch.utils.model_store import load_index
from tinyvc_tpu_torch.utils.weights import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models", "two_speaker")
DEMO = os.path.join(ROOT, "demo", "two_speaker")
# the CLI's output is a 16-bit WAV: one step of int16(x * 32767) read as / 32768
PCM_ATOL = 2.0 / 32767


def _demo(name, start, n):
    return load_audio(os.path.join(DEMO, name))[0][0, start:start + n]


def _to_48k_stereo(path, wave):
    up = resample(torch.from_numpy(wave), 24000, 48000).numpy()
    save_wav(path, np.stack([up, 0.8 * up]), 48000)


def test_infer_cli_resamples_and_reads_pt_weights(tmp_path):
    inputs, outputs = tmp_path / "in", tmp_path / "out"
    inputs.mkdir()
    _to_48k_stereo(str(inputs / "utt.wav"), _demo("source_A.wav", 24000, 19200))
    _to_48k_stereo(str(tmp_path / "target.wav"), _demo("converted_A_to_B.wav", 0, 24000))
    encoder, decoder = (load_npz(os.path.join(MODELS, f"{n}_B.npz"))
                        for n in ("encoder", "decoder"))
    torch.save(encoder_state_dict(encoder), tmp_path / "encoder.pt")
    torch.save(decoder_state_dict(decoder), tmp_path / "decoder.pt")
    cli_infer.main(["-i", str(inputs), "-o", str(outputs), "-encp", str(tmp_path / "encoder.pt"),
                    "-decp", str(tmp_path / "decoder.pt"), "-idx", "NONE",
                    "-t", str(tmp_path / "target.wav"), "-p", "11.99", "--device", "cpu"])
    out, sr = load_audio(str(outputs / "utt.wav"))
    src, src_sr = load_audio(str(inputs / "utt.wav"))
    assert sr == 24000 and src_sr == 48000 and src.shape[0] == 2
    assert out.shape == (1, -(-src.shape[1] // 2))

    # the same request through the API: channels averaged, resampled once
    vc = VoiceConverter(encoder, decoder, device="cpu")
    mono = resample(torch.from_numpy(src.mean(axis=0)), 48000, 24000).numpy()
    tgt, _ = load_audio(str(tmp_path / "target.wav"))
    target = vc.build_dictionary(resample(torch.from_numpy(tgt.mean(axis=0)), 48000, 24000).numpy())
    want = vc.convert(mono, target, 11.99)
    assert np.isfinite(want).all() and np.abs(want).max() > 0.05
    np.testing.assert_allclose(out[0], np.clip(want, -1, 1), atol=PCM_ATOL, rtol=0)


def test_infer_cli_chunked_conversion(tmp_path):
    """``-c 16`` on a 1.2 s WAV: four chunk rows (60 frames, bucketed to 64),
    the output as ``convert_chunked`` gives it, the input's length."""
    inputs, outputs = tmp_path / "in", tmp_path / "out"
    inputs.mkdir()
    wave = _demo("source_A.wav", 24000, 28800)
    save_wav(str(inputs / "utt.wav"), wave)
    cli_infer.main(["-i", str(inputs), "-o", str(outputs),
                    "-encp", os.path.join(MODELS, "encoder_B.npz"),
                    "-decp", os.path.join(MODELS, "decoder_B.npz"),
                    "-idx", os.path.join(MODELS, "index_B.npy"), "-p", "11.99", "-c", "16",
                    "--device", "cpu"])
    out, sr = load_audio(str(outputs / "utt.wav"))
    assert sr == 24000 and out.shape == (1, wave.shape[0])
    vc = VoiceConverter(load_npz(os.path.join(MODELS, "encoder_B.npz")),
                        load_npz(os.path.join(MODELS, "decoder_B.npz")), device="cpu")
    src, _ = load_audio(str(inputs / "utt.wav"))
    want = vc.convert_chunked(src[0], load_index(os.path.join(MODELS, "index_B.npy")), 11.99,
                              chunk_frames=16)
    assert np.isfinite(want).all() and np.abs(want).max() > 0.05
    np.testing.assert_allclose(out[0], np.clip(want, -1, 1), atol=PCM_ATOL, rtol=0)


def test_streaming_cli_file_mode_with_gains_and_pipeline(tmp_path):
    blocks, block = 10, 1920
    wave = _demo("source_A.wav", 0, blocks * block + 700)  # a ragged tail is dropped
    _to_48k_stereo(str(tmp_path / "in.wav"), wave)
    out_path = tmp_path / "out.wav"
    cli_stream.main(["-encp", os.path.join(MODELS, "encoder_B.npz"),
                     "-decp", os.path.join(MODELS, "decoder_B.npz"),
                     "-idx", os.path.join(MODELS, "index_B.npy"), "-p", "11.99",
                     "-ig", "-6", "-og", "3", "--pipeline", "2",
                     "--wav-in", str(tmp_path / "in.wav"), "--wav-out", str(out_path),
                     "--device", "cpu"])
    out, sr = load_audio(str(out_path))
    assert sr == 24000 and out.shape == (1, blocks * block)

    # the same blocks through the API, synchronously, gains applied as the CLI does
    src, _ = load_audio(str(tmp_path / "in.wav"))
    mono = resample(torch.from_numpy(src.mean(axis=0)), 48000, 24000).numpy()
    sc = StreamConverter(load_npz(os.path.join(MODELS, "encoder_B.npz")),
                         load_npz(os.path.join(MODELS, "decoder_B.npz")),
                         load_index(os.path.join(MODELS, "index_B.npy")), pitch_shift=11.99,
                         device="cpu")
    in_gain, out_gain = 10.0 ** (-6 / 20), 10.0 ** (3 / 20)
    want = np.concatenate([
        sc.process_block((mono[b * block:(b + 1) * block] * in_gain).astype(np.float32))
        * out_gain for b in range(blocks)])
    assert np.isfinite(want).all() and np.abs(want[block:]).max() > 0.05
    np.testing.assert_allclose(out[0], np.clip(want, -1, 1), atol=PCM_ATOL, rtol=0)
