"""The port's data preparation against the JAX package's: `train/teacher.py`
(``MFCCTeacher`` bit for bit; ``make_teacher`` without a cache or
``transformers``), `data/noise.py::NoiseGenerator` (the same draws), and
the CLIs ``cli.preprocess --device cpu`` and ``cli.precompute_teacher
--backend mfcc`` on one raw tree: two 24 kHz WAVs (one in a subdirectory)
and a 48 kHz stereo one.

Bounds: chunks cut from 24 kHz files are the same bytes; the resampled
file's chunks differ by at most one 16-bit step, where the two resamplers
(within 1e-6 of the peak of each other, `tests/test_torch_resample.py`)
straddle a rounding, at no more than ``PCM_SHARE`` of its samples
(measured 9 of 48,000); the f0 labels within `tests/test_torch_f0.py`'s
``FLIP_SHARE`` at ``F0_RTOL``; the teacher's features bit for bit where
the chunks are, else within ``TEACHER_TOL`` of the peak."""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_f0 import FLIP_SHARE, f0_mismatch
from tinyvc_tpu_torch.data.noise import NoiseGenerator
from tinyvc_tpu_torch.dsp.resample import resample
from tinyvc_tpu_torch.train import teacher as pteacher
from tinyvc_tpu_torch.utils.audio_io import load_audio, save_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCM_STEP = 1.0 / 32768  # load_audio's int16 scale
PCM_SHARE = 1e-3
TEACHER_TOL = 1e-3  # of the peak, for features of chunks one PCM step apart


@pytest.fixture(scope="module")
def demo():
    return load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))[0][0]


@pytest.fixture(scope="module")
def raw(tmp_path_factory, demo):
    d = tmp_path_factory.mktemp("raw")
    (d / "sub").mkdir()
    save_wav(str(d / "a.wav"), demo[:60000])
    save_wav(str(d / "sub" / "c.wav"), demo[60000:110000])
    w48 = resample(torch.from_numpy(demo[None]), 24000, 48000).numpy()[0][:100000]
    save_wav(str(d / "b48.wav"), np.stack([w48, 0.5 * w48]), 48000)
    return d


def test_mfcc_teacher_matches_jax(rng):
    from tinyvc_tpu.train.teacher import MFCCTeacher as JaxMFCC

    x = (0.2 * rng.standard_normal((3, 48000))).astype(np.float32)
    want = JaxMFCC()(x)
    got = pteacher.MFCCTeacher()(x)
    assert got.shape == want.shape == (3, 101, 768) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_make_teacher_falls_back_to_none(tmp_path, monkeypatch, capsys):
    """No ``0.teacher.npy`` and no ``transformers``: None, with the JAX
    package's warning; with the file, the cached teacher."""
    monkeypatch.setitem(sys.modules, "transformers", None)  # as if not installed
    assert pteacher.make_teacher(str(tmp_path)) is None
    assert "WavLM teacher unavailable (ModuleNotFoundError)" in capsys.readouterr().out
    feats = np.ones((4, 768), np.float32)
    for i in range(2):
        np.save(tmp_path / f"{i}.teacher.npy", feats * i)
    cached = pteacher.make_teacher(str(tmp_path))
    assert isinstance(cached, pteacher.CachedTeacher)
    np.testing.assert_array_equal(cached.for_indices([1, 0]), np.stack([feats, 0 * feats]))


@pytest.mark.parametrize("rate", [24000, 48000])
def test_noise_generator_matches_jax(tmp_path, demo, rate):
    """The same seed mixes the same crops at the same gains: bit for bit
    from 24 kHz noise files, within the resampler's bound from a 48 kHz
    one."""
    from tinyvc_tpu.data.noise import NoiseGenerator as JaxNoise

    noise = demo[::-1].copy()
    if rate != 24000:
        noise = resample(torch.from_numpy(noise[None]), 24000, rate).numpy()[0]
    save_wav(str(tmp_path / "long.wav"), noise, rate)
    save_wav(str(tmp_path / "short.wav"), noise[:3000], rate)
    xs = (0.1 * np.random.default_rng(2).standard_normal((8, 9600))).astype(np.float32)
    port, jax_gen = NoiseGenerator(str(tmp_path), seed=3), JaxNoise(str(tmp_path), seed=3)
    assert len(port.waveforms) == len(jax_gen.waveforms) == 2
    for _ in range(3):
        got, want = port.add_noise(xs), jax_gen.add_noise(xs)
        assert not np.array_equal(want, xs)
        if rate == 24000:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(noise).max())


def _cache_files(d):
    return sorted(f for f in os.listdir(d))


def test_preprocess_and_teacher_clis_match_jax(raw, tmp_path):
    from tinyvc_tpu.cli import precompute_teacher as jax_teacher_cli
    from tinyvc_tpu.cli import preprocess as jax_preprocess_cli
    from tinyvc_tpu_torch.cli import precompute_teacher, preprocess

    port, ref = tmp_path / "port", tmp_path / "jax"
    preprocess.main([str(raw), "-o", str(port), "--device", "cpu", "--f0-batch", "4"])
    jax_preprocess_cli.main([str(raw), "-o", str(ref), "--f0-batch", "4"])
    # files in order: mp3, then wav sorted (a.wav, b48.wav, sub/c.wav)
    assert _cache_files(port) == _cache_files(ref)
    n = len([f for f in os.listdir(port) if f.endswith(".wav")])
    resampled = {i for i in range(n) if i in (2, 3, 4)}  # b48.wav: 100,000 / 2 -> 3 chunks
    assert n == 6
    for i in range(n):
        got, want = load_audio(str(port / f"{i}.wav"))[0], load_audio(str(ref / f"{i}.wav"))[0]
        if i in resampled:
            step = np.abs(got - want)
            assert step.max() <= PCM_STEP * 1.0001 and np.mean(step > 0) <= PCM_SHARE, i
        else:
            assert (port / f"{i}.wav").read_bytes() == (ref / f"{i}.wav").read_bytes(), i
        f0, jf0 = np.load(port / f"{i}.f0.npy"), np.load(ref / f"{i}.f0.npy")
        assert f0.shape == jf0.shape == (100,) and f0.dtype == np.float32
        assert f0_mismatch(f0, jf0) <= FLIP_SHARE, i
    precompute_teacher.main(["--dataset-cache", str(port), "--backend", "mfcc"])
    jax_teacher_cli.main(["--dataset-cache", str(ref), "--backend", "mfcc"])
    for i in range(n):
        got, want = np.load(port / f"{i}.teacher.npy"), np.load(ref / f"{i}.teacher.npy")
        assert got.shape == want.shape == (101, 768)
        if i in resampled:
            assert np.abs(got - want).max() <= TEACHER_TOL * np.abs(want).max(), i
        else:
            np.testing.assert_array_equal(got, want)


def test_wavlm_backend_stops_with_the_jax_message(raw, tmp_path, monkeypatch):
    from tinyvc_tpu_torch.cli import precompute_teacher, preprocess

    monkeypatch.setitem(sys.modules, "transformers", None)
    preprocess.main([str(raw), "-o", str(tmp_path), "--device", "cpu", "-m", "1"])
    with pytest.raises(SystemExit, match="(?s)could not load the WavLM teacher.*--backend mfcc"):
        precompute_teacher.main(["--dataset-cache", str(tmp_path), "--backend", "wavlm"])
    assert not any(f.endswith(".teacher.npy") for f in os.listdir(tmp_path))


def test_preprocess_needs_cuda_unless_cpu_is_asked_for(raw, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from tinyvc_tpu_torch.cli import preprocess

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess.main([str(raw), "-o", str(tmp_path)])
