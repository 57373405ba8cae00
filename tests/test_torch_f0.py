"""The port's f0 estimation (`tinyvc_tpu_torch/dsp/f0.py`) against the JAX
package's (`tinyvc_tpu/dsp/f0.py`) on the signals of `tests/test_f0.py` (pure
tones, a harmonic-rich tone, silence and white noise, a chirp) and on
speech: the first 2 s of the demo utterance, clean and with noise.

YIN's voicing is a threshold on fp32 cumulative sums, whose order of
additions differs between frameworks and FFT libraries, so a frame may
change its decision. The comparison (:func:`f0_mismatch`) counts a frame as
differing when its voicing differs or, voiced on both sides, its f0 differs
by more than ``F0_RTOL``; at most ``FLIP_SHARE`` of the frames may differ.
Measured before the bounds were fixed: no frame differs on any signal here,
and voiced frames agree within 7.7e-7 relative. `chip_smoke.py` holds the
card's labels to the CPU's with the same two numbers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu.dsp.f0 import estimate_f0 as jax_estimate_f0
from tinyvc_tpu.dsp.f0 import yin as jax_yin
from tinyvc_tpu_torch.dsp.f0 import estimate_f0, yin
from tinyvc_tpu_torch.utils.audio_io import load_audio

SR = 24000
F0_RTOL = 1e-4
FLIP_SHARE = 0.02
DEMO = "demo/two_speaker/source_A.wav"


def f0_mismatch(got: np.ndarray, want: np.ndarray) -> float:
    """The share of frames whose voicing differs or whose f0 differs by more
    than ``F0_RTOL`` of the reference's."""
    vg, vw = got > 0, want > 0
    both = vg & vw
    off = np.abs(got - want) > F0_RTOL * np.abs(want)
    return float(np.mean((vg != vw) | (both & off)))


def _tone(freq, seconds=2.0, amp=0.3):
    t = np.arange(int(SR * seconds)) / SR
    return (np.sin(2 * np.pi * freq * t) * amp).astype(np.float32)


def _harmonic():
    t = np.arange(SR * 2) / SR
    x = sum(np.sin(2 * np.pi * 140.0 * k * t) / k for k in range(1, 8))
    return (x / np.abs(x).max() * 0.4).astype(np.float32)


def _chirp():
    L = SR * 2
    phase = np.cumsum(np.linspace(100, 300, L) / SR)
    return (np.sin(2 * np.pi * phase) * 0.3).astype(np.float32)


def _speech(noise: float):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    w = load_audio(os.path.join(root, DEMO))[0][0, :2 * SR]
    return (w + noise * np.random.default_rng(1).standard_normal(w.shape)).astype(np.float32)


SIGNALS = {
    "tones": lambda rng: np.stack([_tone(f) for f in (80.0, 150.0, 440.0, 800.0)]),
    "harmonic": lambda rng: _harmonic()[None],
    "silence_noise": lambda rng: np.stack([np.zeros(SR * 2, np.float32),
                                           (rng.standard_normal(SR * 2) * 0.1).astype(np.float32)]),
    "chirp": lambda rng: _chirp()[None],
    "speech": lambda rng: _speech(0.0)[None],
    "noisy_speech": lambda rng: _speech(0.02)[None],
}


@pytest.mark.parametrize("name", list(SIGNALS))
def test_yin_matches_jax(rng, name):
    x = SIGNALS[name](rng)
    want = np.asarray(jax_yin(jnp.asarray(x), SR))
    got = yin(torch.from_numpy(x), SR).numpy()
    assert got.shape == want.shape == (x.shape[0], x.shape[1] // 480)
    share = f0_mismatch(got, want)
    print(f"{name}: {share:.4f} of {got.size} frames differ")
    assert share <= FLIP_SHARE


def test_yin_tracks_tones_and_gates_silence(rng):
    """The port's own estimates keep `tests/test_f0.py`'s accuracy."""
    f0 = yin(torch.from_numpy(SIGNALS["tones"](rng)), SR).numpy()
    for row, freq in zip(f0, (80.0, 150.0, 440.0, 800.0)):
        voiced = row[5:-5]
        assert (voiced > 0).mean() > 0.95
        assert abs(np.median(voiced[voiced > 0]) - freq) / freq < 0.01
    f0 = yin(torch.from_numpy(SIGNALS["silence_noise"](rng)), SR).numpy()
    assert (f0[0] == 0).all() and (f0[1] == 0).mean() > 0.8


def test_estimate_f0_matches_jax_on_a_chirp():
    x = _chirp()[None]
    want = np.asarray(jax_estimate_f0(jnp.asarray(x), SR, 480))
    got = estimate_f0(torch.from_numpy(x), SR, 480).numpy()
    assert f0_mismatch(got, want) <= FLIP_SHARE
    f_true = np.linspace(100, 300, x.shape[1])[np.arange(got.shape[1]) * 480]
    assert np.median(np.abs(got[0, 5:-5] - f_true[5:-5]) / f_true[5:-5]) < 0.02


def test_estimate_f0_shape_and_names(rng):
    wf = torch.from_numpy((rng.standard_normal((3, 48000)) * 0.1).astype(np.float32))
    assert estimate_f0(wf, SR, 480).shape == (3, 100)
    with pytest.raises(ValueError, match="unknown f0 algorithm"):
        estimate_f0(torch.zeros(1, 4800), SR, 480, algorithm="nope")
    for name, package in (("dio", "pyworld"), ("harvest", "pyworld"), ("fcpe", "torchfcpe")):
        try:
            __import__(package)
        except ImportError:
            with pytest.raises(ImportError, match=package):
                estimate_f0(torch.zeros(1, 4800), SR, 480, algorithm=name)
