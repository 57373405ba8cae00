"""Streaming conversion of the port (`tinyvc_tpu_torch/infer/stream.py`)
against `tinyvc_tpu.infer.stream` on the CPU: the fade windows, the phase
vocoder, the key schedule, and a stream of blocks at small widths with
random weights, block by block, with the sin² crossfade and the phase
vocoder; then the port's pipelined dispatch, reset and latency, and a
stream over a sharded dictionary (``mesh=``) at one rank."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.infer import stream as jstream
from tinyvc_tpu.models import Decoder, Encoder
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.infer import stream as pstream
from tinyvc_tpu_torch.utils import prng
from torch_parity import random_params

ENC = dict(pitch_channels=16, pitch_num_layers=1, ssl_channels=16, ssl_dilations=(1,),
           ssl_dim=32)
DEC = dict(num_harmonics=4, source_channels=16, source_num_layers=1,
           filter_channels=(32, 24, 16, 12, 8), content_channels=32)
# block 480: a window of 480 + 480 + 480 + 2 * 960 = 3360 samples, 7 frames
STREAM = dict(block_size=480, extra_size=960, sola_search_size=480, crossfade_size=480,
              last_delay_size=960)
BLOCKS = 6
# port against JAX, each block relative to the JAX block's peak: fp32 sums in
# other orders through the ConvNeXt stacks and the U-Net, XLA's parallel
# cumsum of the harmonics' phase against torch's sequential one (the
# whole-utterance test's 1e-4, tests/test_torch_convert.py); measured 1.6e-5
# with either crossfade, six blocks, shifts 0, 102, 64, 26, 115, 193
BLOCK_RTOL = 1e-4


def test_fade_windows_match_jax():
    for n in (480, 1920, 1000, 3):
        want = [np.asarray(w) for w in jstream._fade_windows(n)]
        got = [w.numpy() for w in pstream._fade_windows(n)]
        for g, w in zip(got, want):
            assert g.shape == w.shape == (n,)
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [480, 257])
def test_phase_vocoder_matches_jax(rng, n):
    a, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    fade_in, fade_out = jstream._fade_windows(n)
    want = np.asarray(jstream.phase_vocoder(jnp.asarray(a), jnp.asarray(b), fade_out, fade_in))
    fi, fo = pstream._fade_windows(n)
    got = pstream.phase_vocoder(torch.from_numpy(a), torch.from_numpy(b), fo, fi).numpy()
    # two fp32 FFT libraries and a 2n-term cos sum: 1e-5 of the peak
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_key_schedule_is_jax_split():
    key, jkey = prng.prng_key(3), jax.random.PRNGKey(3)
    for _ in range(5):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jkey)))
        np.testing.assert_array_equal(sub, np.asarray(jax.random.key_data(jsub)))


def _voiced(rng, L, sr=24000):
    t = np.arange(L) / sr
    f = np.linspace(110.0, 180.0, L)
    w = 0.3 * np.sin(2 * np.pi * np.cumsum(f) / sr) + 0.1 * np.sin(4 * np.pi * 150.0 * t)
    return (w + 0.02 * rng.standard_normal(L)).astype(np.float32)


def _setup(rng, phase_vocoder: bool, draw=random_params):
    scfg = dict(STREAM, use_phase_vocoder=phase_vocoder)
    jc = jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC), decoder=jcfg.DecoderConfig(**DEC),
                           stream=jcfg.StreamConfig(**scfg))
    pc = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC), decoder=pcfg.DecoderConfig(**DEC),
                           stream=pcfg.StreamConfig(**scfg))
    F = jc.stream.input_size // 480
    E, D = Encoder(jc.encoder), Decoder(jc.decoder, jc.audio)
    enc_p = draw(E, jnp.zeros((1, F, 961)))
    # random weights decode f0 in the kHz; push the pitch head towards class
    # 140 (~150 Hz), as tests/test_torch_convert.py does
    head = enc_p["params"]["pitch_estimator"]["stack"]["output_layer"]
    head["bias"] = head["bias"] + 8.0 * np.exp(-(((np.arange(512) - 140) / 20.0) ** 2))
    dec_p = draw(D, jnp.zeros((1, F, 32)), jnp.full((1, F), 100.0),
                          jnp.zeros((1, F * 480)), jnp.zeros((2,), jnp.uint32),
                          noise_angle=jnp.zeros((1, F, 961)))
    target = rng.standard_normal((40, 32)).astype(np.float32)
    wave = _voiced(rng, BLOCKS * 480)
    return jc, pc, F, enc_p, dec_p, target, wave


def _jax_noise(F):
    """The JAX package's noise draw on its CPU path, as the port's phases:
    ``jax.random.uniform(subkey, (1, F, bins), -pi, pi)``
    (`tinyvc_tpu/models/decoder.py:101-104`)."""
    def noise(subkey):
        angle = prng.uniform(subkey, (1, F, 961), -math.pi, math.pi)
        return 0, torch.from_numpy(angle)
    return noise


class _ShiftSpy:
    """``jnp`` for `tinyvc_tpu.infer.stream` that also reports each
    ``argmax`` (the SOLA shift) and its input to the host."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, *args, **kwargs):
        out = jnp.argmax(x, *args, **kwargs)
        jax.debug.callback(lambda s, c: self.seen.append((int(s), np.asarray(c))), out, x,
                           ordered=True)
        return out


@pytest.mark.parametrize("phase_vocoder", [False, True], ids=["sin2", "phase_vocoder"])
def test_stream_matches_jax_block_by_block(rng, monkeypatch, phase_vocoder):
    jc, pc, F, enc_p, dec_p, target, wave = _setup(rng, phase_vocoder)
    spy = _ShiftSpy()
    monkeypatch.setattr(jstream, "jnp", spy)
    key = jax.random.PRNGKey(5)
    jsc = jstream.StreamConverter(enc_p, dec_p, target, jc, pitch_shift=3.0, key=key)
    psc = pstream.StreamConverter(enc_p, dec_p, target, pc, pitch_shift=3.0,
                                  key=np.asarray(jax.random.key_data(key)), device="cpu",
                                  noise=_jax_noise(F))
    shifts, dists = [], []
    for b in range(BLOCKS):
        block = wave[b * 480:(b + 1) * 480]
        want = jsc.process_block(block)
        stats = {}
        got = psc.step(block, stats).numpy()
        js, jcorr = spy.seen[b]
        ps = int(stats["shift"])
        corr = stats["corr"].numpy()
        assert got.shape == want.shape == (480,) and np.isfinite(got).all()
        # the correlations agree and both pick the same shift
        np.testing.assert_allclose(corr, jcorr, atol=1e-4, rtol=0)
        shifts.append((ps, js))
        dists.append(float(np.abs(got - want).max() / np.abs(want).max()))
        assert ps == js, f"block {b}: SOLA shift {ps} != JAX's {js}"
        assert dists[-1] <= BLOCK_RTOL, f"block {b}: {dists[-1]:.3e} of the peak"
    assert len({s for s, _ in shifts[1:]}) > 1 or shifts[-1][0] != 0  # SOLA does move
    print(f"shifts {shifts}, distance to JAX {max(dists):.3e} of each block's peak "
          f"(bound {BLOCK_RTOL:.0e})")


def _port_stream(rng, **kwargs):
    jc, pc, F, enc_p, dec_p, target, wave = _setup(rng, False)
    sc = pstream.StreamConverter(enc_p, dec_p, target, pc, pitch_shift=3.0, device="cpu",
                                 **kwargs)
    return sc, [wave[b * 480:(b + 1) * 480] for b in range(BLOCKS)]


def test_pipelined_outputs_equal_synchronous(rng):
    sc, blocks = _port_stream(rng)
    sync = [sc.process_block(b) for b in blocks]
    for depth in (1, 2):
        sc.reset()
        sc.state.key = prng.prng_key(0)
        got = []
        for b in blocks:
            out = sc.process_block_pipelined(b, depth=depth)
            assert sc.in_flight() <= depth
            if out is not None:
                got.append(out)
        assert len(got) == BLOCKS - depth
        got.extend(sc.drain())
        assert sc.in_flight() == 0
        for g, s in zip(got, sync):
            np.testing.assert_array_equal(g, s)


def test_reset_keeps_the_key_and_latency(rng):
    sc, blocks = _port_stream(rng)
    s = sc.cfg.stream
    assert sc.block_size == 480
    assert sc.latency_samples == s.input_size - s.block_size == 2880
    first = sc.process_block(blocks[0])
    np.testing.assert_array_equal(sc.state.key, prng.split(prng.prng_key(0))[0])
    sc.submit_block(blocks[1])
    key = sc.state.key.copy()
    sc.reset()
    assert sc.in_flight() == 0
    np.testing.assert_array_equal(sc.state.key, key)
    assert not sc.state.input_wav.any() and not sc.state.sola_buffer.any()
    # the same block from a zero state with the next key: another noise draw
    again = sc.process_block(blocks[0])
    assert np.isfinite(again).all() and not np.array_equal(again, first)
    with pytest.raises(ValueError, match="block of 480"):
        sc.process_block(blocks[0][:100])


@pytest.fixture()
def one_rank_group():
    """A gloo process group of this process alone, for the length of a test."""
    import torch.distributed as dist
    from torch_dist import free_port

    from tinyvc_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_mesh_stream_at_one_rank_is_the_plain_stream(rng, one_rank_group):
    """``mesh=`` streams: at one rank (one shard), through the sharded match
    and its collectives, the same blocks and shifts as without a mesh up to
    the mean's sum order (`tests/test_torch_sharded_knn.py` holds two ranks
    to JAX's)."""
    sc, blocks = _port_stream(rng)
    plain = []
    for b in blocks:
        stats = {}
        plain.append((sc.step(b, stats).numpy(), int(stats["shift"])))
    sc, blocks = _port_stream(np.random.default_rng(0), mesh=one_rank_group)
    assert sc.target[0].shape == (40, 32) and bool(sc.target[1].all())  # no padding at S=1
    for b, (want, shift) in zip(blocks, plain):
        stats = {}
        got = sc.step(b, stats).numpy()
        assert int(stats["shift"]) == shift
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


def test_mesh_stream_needs_one_data_row(rng):
    from tinyvc_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="needs data=1"):
        _port_stream(rng, mesh=Mesh(data=2, model=1, rank=0, data_group=None, model_group=None))
