"""The traffic generator: deterministic per seed, sized as its file says,
and the same work for every seed."""

import numpy as np
import pytest

from vcbench.harness import traffic
from vcbench.conftest import SMALL_TRAFFIC
from vcbench.harness.cells import load_json, ROOT

AUDIO = {"sample_rate": 24000, "hop_size": 480}


def _params(name="batch16-dict4k"):
    p = load_json(f"{ROOT}/vcbench/traffic/{name}.json")
    p.update(SMALL_TRAFFIC)
    return p


def test_same_seed_same_inputs():
    p = _params()
    a, b = traffic.make(p, 2**31 + 5, AUDIO, "cpu"), traffic.make(p, 2**31 + 5, AUDIO, "cpu")
    assert np.array_equal(a.target, b.target)
    for i in range(7):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.wave, rb.wave)
        assert (ra.length, ra.pitch_shift, ra.seed) == (rb.length, rb.pitch_shift, rb.seed)


def test_sized_as_the_file_says():
    p = _params()
    t = traffic.make(p, 9, AUDIO, "cpu")
    n = p["lengths_per_cycle"]
    assert len(t.lengths) == n
    assert min(t.lengths) > p["seconds_min"] * 24000 and max(t.lengths) < p["seconds_max"] * 24000
    assert t.target.shape == (p["dictionary"]["utterances"], p["dictionary"]["frames"] * 480)
    for i in range(2 * n):
        r = t.request(i)
        assert r.wave.shape == (p["batch"], r.length) and r.wave.dtype == np.float32
        assert r.pitch_shift == p["pitch_shifts"][i % len(p["pitch_shifts"])]
        assert 0 <= r.seed < 2**31
    warm = t.warm_requests(480, 64)
    assert sorted({traffic.bucket(n, 480, 64) for n in t.lengths}) == [
        traffic.bucket(r.length, 480, 64) for r in warm]
    # each cycle takes every length once
    for c in range(2):
        assert sorted(t.request(c * n + j).length for j in range(n)) == sorted(t.lengths)
    # distinct utterances within a request, speech-like level
    w = t.request(0).wave
    assert not np.allclose(w[0], w[1]) and np.abs(w).max() == pytest.approx(0.5, rel=1e-5)


def test_seeds_change_the_sound_not_the_work():
    p = _params()
    a, b = traffic.make(p, 1, AUDIO, "cpu"), traffic.make(p, 2**33 + 1, AUDIO, "cpu")
    assert a.lengths == b.lengths
    assert not np.array_equal(a.target, b.target)


def test_full_mix_has_nine_bucket_shapes():
    p = load_json(f"{ROOT}/vcbench/traffic/batch16-dict24k.json")
    lengths = traffic.cycle_lengths(p, 24000)
    assert len({traffic.bucket(n, 480, 64) for n in lengths}) == 9
    assert p["dictionary"]["utterances"] * p["dictionary"]["frames"] == 24000
    p4 = load_json(f"{ROOT}/vcbench/traffic/batch16-dict4k.json")
    rows = p4["dictionary"]["utterances"] * p4["dictionary"]["frames"]
    assert rows * 768 * 4 == 12 * 2**20  # exactly kernel H's gate
