"""The port's native audio library (`tinyvc_tpu_torch/data/native_loader.py`
over `tinyvc_tpu_torch/native/tinyvc_audio.cc`): built by the port into
``tinyvc_tpu_torch/kernels/_build/``, never read from ``native/``; its WAV
decode equals the scipy decode; its prefetch loader gives the JAX package's
batches on one cache and seed (one worker thread each, so the order is
fixed); a corrupt chunk is zero-filled with a warning; and the training
loop says which loader it took."""

import os
import re

import numpy as np
import pytest

from tinyvc_tpu_torch.data import native_loader as nl
from tinyvc_tpu_torch.utils.audio_io import _load_wav, load_audio, save_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 4800


@pytest.fixture(scope="module")
def lib():
    lib = nl.load_library()
    if lib is None:
        pytest.skip("no C++ compiler builds the native library here")
    return lib


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache")
    wave = load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))[0][0]
    for i in range(7):
        save_wav(str(d / f"{i}.wav"), wave[5000 * i: 5000 * i + CHUNK])
        np.save(d / f"{i}.f0.npy", np.full(CHUNK // 480, 100.0 + i, np.float32))
    return str(d)


def test_library_is_the_ports_own_build(lib):
    path = nl.library_path()
    assert path.exists() and path.parent.parent == nl.BUILD_DIR
    assert nl.BUILD_DIR == (nl.SOURCE.parent.parent / "kernels" / "_build").resolve()
    assert nl.SOURCE.read_bytes() != b"" and "native-" in path.parent.name
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    assert "libtinyvc_audio.so" in path.name and os.path.join(ROOT, "native") not in str(path)


def test_load_wav_equals_scipy(lib, tmp_path, rng):
    native = nl.NativeAudio.maybe_create()
    x = np.clip(rng.standard_normal((2, 5000)) * 0.3, -0.99, 0.99).astype(np.float32)
    for data, rate in ((x[0], 24000), (x, 48000)):
        path = str(tmp_path / f"t{rate}.wav")
        save_wav(path, data, rate)
        got, sr = native.load_wav(path)
        want, sr2 = _load_wav(path)
        assert sr == sr2 == rate and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    (tmp_path / "bad.wav").write_bytes(b"RIFF....not a wave file")
    assert native.load_wav(str(tmp_path / "bad.wav")) is None


def test_prefetch_batches_match_jax(lib, cache):
    from tinyvc_tpu.data.native_loader import NativePrefetchLoader as JaxLoader

    kw = dict(chunk_len=CHUNK, f0_len=CHUNK // 480, num_threads=1, seed=11)
    port, ref = nl.NativePrefetchLoader(cache, 7, 3, **kw), JaxLoader(cache, 7, 3, **kw)
    try:
        for _ in range(6):  # past the end of the first pass: the reshuffle too
            a, b = port.next(), ref.next()
            np.testing.assert_array_equal(a["wave"], b["wave"])
            np.testing.assert_array_equal(a["f0"], b["f0"])
            assert a["wave"].shape == (3, CHUNK) and port.error_count == 0
    finally:
        port.close()
        ref.close()


def test_corrupt_chunk_warns(lib, cache, tmp_path, capsys):
    import shutil

    d = tmp_path / "c"
    shutil.copytree(cache, d)
    (d / "2.wav").write_bytes(b"garbage")
    loader = nl.NativePrefetchLoader(str(d), 7, 7, chunk_len=CHUNK, f0_len=CHUNK // 480,
                                     num_threads=1)
    try:
        batch = loader.next()
    finally:
        loader.close()
    out = capsys.readouterr().out
    # the worker may have read the file again for the next batch by now
    assert re.search(r"native loader hit [1-9]\d* decode failure", out) and "zero-filled" in out
    assert (np.abs(batch["wave"]).max(axis=1) == 0).sum() == 1


def test_training_loader_choice(lib, cache, monkeypatch, capsys):
    from tinyvc_tpu_torch import config as pcfg
    from tinyvc_tpu_torch.train.loop import _make_loader

    cfg = pcfg.TinyVCConfig(train=pcfg.TrainConfig(batch_size=2, chunk_length=CHUNK))
    monkeypatch.delenv("TINYVC_NO_NATIVE_LOADER", raising=False)
    epochs, n = _make_loader(cfg, cache, 0)
    batch = next(next(epochs))
    assert n == 7 and "using native prefetch loader" in capsys.readouterr().out
    assert batch["wave"].shape == (2, CHUNK) and "idx" not in batch
    monkeypatch.setenv("TINYVC_NO_NATIVE_LOADER", "1")
    epochs, _ = _make_loader(cfg, cache, 0)
    assert "idx" in next(next(epochs)) and "Python DataLoader" in capsys.readouterr().out
