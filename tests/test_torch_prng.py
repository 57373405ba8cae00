"""The port's numpy threefry (`tinyvc_tpu_torch/utils/prng.py`) against
`jax.random` with this installation's defaults (threefry2x32, partitionable,
x64 off), and the seed contract: ``VoiceConverter.convert(seed=s)`` hands
kernel B the int32 that the JAX package's ``convert(key=PRNGKey(s))`` hands
its noise kernel. Integer arithmetic: every comparison is exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinyvc_tpu_torch.utils import prng

SEEDS = (0, 1, 42, 2**31 - 1, 2**40 + 3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models", "two_speaker")


def test_jax_defaults_are_the_ones_ported():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_randint_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.prng_key(seed), np.asarray(key))
    np.testing.assert_array_equal(prng.split(prng.prng_key(seed)),
                                  np.asarray(jax.random.split(key)))
    np.testing.assert_array_equal(prng.split(prng.prng_key(seed), 3),
                                  np.asarray(jax.random.split(key, 3)))
    assert prng.random_bits32(prng.prng_key(seed)) == int(jax.random.bits(key, (), jnp.uint32))
    want = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32))
    assert prng.randint_int32(prng.prng_key(seed)) == want
    assert prng.kernel_b_seed(seed) == want
    # another span, where the modulus multiplier is not 0
    assert prng.randint_int32(prng.prng_key(seed), -5, 1000) == int(
        jax.random.randint(key, (), -5, 1000, dtype=jnp.int32))


@pytest.mark.parametrize("seed", (0, 42))
def test_convert_hands_kernel_b_the_jax_seed(seed, monkeypatch):
    """The host entry point derives kernel B's seed from the JAX key; the
    functions below it take kernel B's seed as it is."""
    import torch

    from tinyvc_tpu_torch.infer import generator
    from tinyvc_tpu_torch.utils.weights import load_npz

    seen = []

    def fake_convert_fn(encoder, decoder, wave, target, pitch_shift, s, cfg, *a, **k):
        seen.append(s)
        return torch.zeros_like(wave)

    monkeypatch.setattr(generator, "convert_fn", fake_convert_fn)
    vc = generator.VoiceConverter(load_npz(os.path.join(MODELS, "encoder_B.npz")),
                                  load_npz(os.path.join(MODELS, "decoder_B.npz")), device="cpu")
    vc.convert(np.zeros(4800, np.float32), np.zeros((8, 768), np.float32), seed=seed)
    key = jax.random.PRNGKey(seed)
    assert seen == [int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max,
                                           dtype=jnp.int32))]


@pytest.mark.parametrize("seed", (0, 1, 42, 2**31 - 1))
@pytest.mark.parametrize("shape", ((2, 1), (2, 20, 961)))
def test_uniform_matches_jax(seed, shape):
    """The training step's draws: the gain ``uniform(k, (B, 1))`` and the
    noise phases ``uniform(k, (B, F, 961), -pi, pi)``, bit for bit."""
    import math

    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.random_bits(prng.prng_key(seed), shape),
                                  np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-math.pi, math.pi)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
        got = prng.uniform(prng.prng_key(seed), shape, lo, hi)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
