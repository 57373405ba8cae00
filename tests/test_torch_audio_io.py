"""The port's audio loader (`tinyvc_tpu_torch/utils/audio_io.py`) against
`tinyvc_tpu.utils.audio_io` on WAV files the test writes, with the JAX
package's optional C++ reader out of the way (the port reads WAV as its
numpy path does)."""

import wave

import numpy as np
import pytest
from scipy.io import wavfile

from tinyvc_tpu.utils import audio_io as jaudio
from tinyvc_tpu_torch.utils import audio_io as paudio


def _samples(rng, fmt, channels, n=1001):
    x = rng.uniform(-1.0, 1.0, (n, channels))
    if fmt == "pcm16":
        return (x * 32767).astype(np.int16)
    if fmt == "pcm32":
        return (x * 2147483647).astype(np.int32)
    if fmt == "uint8":
        return (x * 127 + 128).astype(np.uint8)
    return x.astype(np.float32)


def _write_24bit(path, rng, channels, sr, n=1001):
    ints = rng.integers(-(2**23), 2**23, (n, channels)).astype(np.int32)
    raw = ints.astype("<i4").view(np.uint8).reshape(n, channels, 4)[..., :3]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(3)
        w.setframerate(sr)
        w.writeframes(raw.tobytes())


@pytest.fixture()
def no_native(monkeypatch):
    monkeypatch.setattr(jaudio, "_native_lib", lambda: None)


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("fmt", ["pcm16", "pcm24", "pcm24_wave", "pcm32", "float32", "uint8"])
def test_load_audio_matches_jax(rng, tmp_path, no_native, monkeypatch, fmt, channels):
    path = str(tmp_path / f"{fmt}.wav")
    sr = 44100 if channels == 2 else 16000
    if fmt.startswith("pcm24"):
        _write_24bit(path, rng, channels, sr)
    else:
        data = _samples(rng, fmt, channels)
        wavfile.write(path, sr, data[:, 0] if channels == 1 else data)
    if fmt == "pcm24_wave":
        # the 24-bit parse through `wave`, which both take when scipy refuses
        real = wavfile.read

        def refuse_24bit(p, *a, **k):
            with wave.open(p, "rb") as w:
                if w.getsampwidth() == 3:
                    raise ValueError("24-bit")
            return real(p, *a, **k)

        monkeypatch.setattr(wavfile, "read", refuse_24bit)
    got, got_sr = paudio.load_audio(path)
    want, want_sr = jaudio.load_audio(path)
    assert got_sr == want_sr == sr
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (channels, 1001)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 1.0


def test_non_wav_needs_ffmpeg(tmp_path, monkeypatch):
    path = tmp_path / "clip.ogg"
    path.write_bytes(b"OggS")
    monkeypatch.setattr(paudio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="need ffmpeg"):
        paudio.load_audio(str(path))


@pytest.mark.parametrize("shape", [(700,), (2, 700)], ids=["mono", "stereo"])
def test_save_wav_round_trips(rng, tmp_path, shape):
    x = rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    path = str(tmp_path / "out.wav")
    paudio.save_wav(path, x, 22050)
    got, sr = paudio.load_audio(path)
    assert sr == 22050 and got.shape == (1,) * (len(shape) == 1) + shape
    # written as int16(x * 32767), truncated (up to one step), read as / 32768
    np.testing.assert_allclose(got.reshape(shape), x, atol=2.0 / 32767)
    # the same bytes as the JAX package's writer
    jaudio.save_wav(str(tmp_path / "jax.wav"), x, 22050)
    assert (tmp_path / "jax.wav").read_bytes() == (tmp_path / "out.wav").read_bytes()
