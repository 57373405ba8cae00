"""kNN dictionary extraction (`infer/index.py`, `cli/extract_index.py`)
against `tinyvc_tpu.infer.index.extract_index` on a cache of 0.4 s chunks
written by the test: the same seed picks the same batches, frames and
shuffle, so the rows come in the same order."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_convert import ENC
from tinyvc_tpu import config as jcfg
from tinyvc_tpu.infer.index import extract_index as j_extract_index
from tinyvc_tpu.models import Encoder
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.cli import extract_index as cli
from tinyvc_tpu_torch.infer.index import extract_index
from tinyvc_tpu_torch.utils.audio_io import save_wav
from tinyvc_tpu_torch.utils.weights import load_npz
from torch_parity import random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models", "two_speaker")
CHUNK = 9600  # 0.4 s at 24 kHz: 20 frames


def _cache(path, rng, n=5):
    """``{i}.wav`` chunks of a swept tone in noise, with ``{i}.f0.npy``."""
    t = np.arange(CHUNK) / 24000
    for i in range(n):
        f = rng.uniform(90, 300)
        wave = 0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(CHUNK)
        save_wav(str(path / f"{i}.wav"), wave.astype(np.float32))
        np.save(path / f"{i}.f0.npy", np.full(CHUNK // 480, f, np.float32))
    return str(path)


# size 12: the loop stops after two batches of 10 rows and keeps 12 of 20;
# size 64: every row of the two whole batches (the fifth chunk is the
# dropped ragged tail), shuffled
@pytest.mark.parametrize("size", [12, 64])
def test_extract_index_matches_jax(rng, tmp_path, size):
    cache = _cache(tmp_path, rng)
    jc = jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC))
    params = random_params(Encoder(jc.encoder), jnp.zeros((1, 8, 961)))
    want = j_extract_index(params, cache, size=size, stride=4, seed=3, cfg=jc, batch_size=2)
    got = extract_index(params, cache, size=size, stride=4, seed=3,
                        cfg=pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC)), batch_size=2,
                        device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (min(size, 20), 32)
    # the same rows in the same order, each within the encoder's bound of
    # tests/test_torch_modules.py::test_encoder_infer (1e-4 of the feature scale)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_extract_index_cli_on_cpu(tmp_path, rng):
    """The CLI at full width with the two-speaker encoder: the function's
    rows; without ``--device cpu`` it needs CUDA."""
    (tmp_path / "cache").mkdir()
    cache = _cache(tmp_path / "cache", rng)
    out = tmp_path / "index.npy"
    args = ["--dataset-cache", cache, "-encp", os.path.join(MODELS, "encoder_B.npz"),
            "-size", "16", "-o", str(out)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(args)
    cli.main(args + ["--device", "cpu"])
    index = np.load(out)
    want = extract_index(load_npz(os.path.join(MODELS, "encoder_B.npz")), cache, size=16,
                         device="cpu")
    assert index.shape == (16, 768) and index.dtype == np.float32
    np.testing.assert_array_equal(index, want)
