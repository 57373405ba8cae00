"""The port's sharded kNN (`tinyvc_tpu_torch/parallel/sharded_knn.py`), its
sharded conversion (`infer/generator.py::convert_fn_sharded`) and its
stream over a sharded dictionary (`StreamConverter(mesh=)`) on two gloo
ranks on the CPU, against the JAX package's on a ``make_mesh(data=1,
model=2)`` mesh of the CPU's virtual devices (`tests/conftest.py`). One
launch of `tests/torch_dist_worker.py` runs every case; each rank imports
only the port.

The kNN cases: both payloads with the cos and IP metrics, a blend (alpha),
a dictionary smaller than ``k * S`` (a shard of padding), a planted tie
across the shards in both payloads (lowest candidate index wins, as
``jax.lax.top_k``), a ``data=2`` mesh. A different neighbour would move an output by a quarter
of a dictionary row's distance to the winner (~0.1 here), so outputs
within 1e-6 are equal neighbours."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_fused_convert import DEC, ENC
from test_torch_stream import BLOCK_RTOL, BLOCKS, STREAM, _setup, _ShiftSpy
from test_torch_stream import DEC as S_DEC
from test_torch_stream import ENC as S_ENC
from tinyvc_tpu import config as jcfg
from tinyvc_tpu.infer import stream as jstream
from tinyvc_tpu.infer.generator import convert_fn_sharded
from tinyvc_tpu.models import Decoder, Encoder
from tinyvc_tpu.parallel import make_mesh, pad_dictionary, sharded_match_features
from torch_dist import flat, run
from torch_parity import numpy_params

KNN_ATOL = 1e-6
CONVERT_RTOL = 2e-5  # of the peak
F_CONV, PITCH = 16, 5.0


def _mesh(data, model):
    return make_mesh(data=data, model=model, devices=jax.devices()[:data * model])


def _tie_dictionary():
    """Rows 0, 2, 3 nearest to e_0; rows 1 and 6 tie for the fourth place
    (equal norms, equal cosine and inner product with e_0), one in each
    shard of two; the rest point away."""
    d = np.zeros((8, 8), np.float32)
    d[[0, 2, 3], 0] = 1.0
    d[0, 2], d[2, 3], d[3, 4] = 0.1, 0.1, 0.1
    d[1, :2] = (1.0, 0.5)
    d[6, :2] = (1.0, -0.5)
    d[[4, 5, 7], 0] = -1.0
    d[[4, 5, 7], [5, 6, 7]] = 0.3
    return d


def _knn_cases(rng):
    src = rng.standard_normal((2, 6, 16)).astype(np.float32)
    big = rng.standard_normal((37, 16)).astype(np.float32)
    tie_src = np.zeros((1, 3, 8), np.float32)
    tie_src[0, 0, 0], tie_src[0, 1, 0] = 1.0, 2.0
    tie_src[0, 2] = rng.standard_normal(8)
    return {
        "index_cos": (dict(payload="index", metric="cos"), src, big),
        "vectors_IP": (dict(payload="vectors", metric="IP"), src, big),
        "index_IP_alpha": (dict(payload="index", metric="IP", alpha=0.3), src, big),
        "small_dict_vectors_cos": (dict(payload="vectors", metric="cos"), src, big[:5]),
        "tie_index_cos": (dict(payload="index", metric="cos"), tie_src, _tie_dictionary()),
        "tie_vectors_IP": (dict(payload="vectors", metric="IP"), tie_src, _tie_dictionary()),
        "data2_index_cos": (dict(payload="index", metric="cos", mesh=[2, 1]), src, big),
    }


@functools.lru_cache(maxsize=None)
def _model():
    jc = jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC), decoder=jcfg.DecoderConfig(**DEC))
    E, D = Encoder(jc.encoder), Decoder(jc.decoder, jc.audio)
    L = F_CONV * 480
    enc_p = numpy_params(E, jnp.zeros((1, F_CONV, 961)))
    # the pitch head steered to class 0, which decodes as unvoiced: the
    # harmonics are then exactly zero on both sides, whose phase rounding
    # differs by design (XLA's parallel cumsum, ROADMAP.md §3; voiced, the
    # port's own convert_fn is 3.8e-5 of the peak from JAX's on these inputs)
    head = enc_p["params"]["pitch_estimator"]["stack"]["output_layer"]
    head["bias"] = head["bias"] + 1000.0 * (np.arange(512) == 0)
    dec_p = numpy_params(D, jnp.zeros((1, F_CONV, 32)), jnp.full((1, F_CONV), 100.0),
                          jnp.zeros((1, L)), jnp.zeros((2,), jnp.uint32),
                          noise_angle=jnp.zeros((1, F_CONV, 961)))
    return jc, E, D, enc_p, dec_p


@functools.lru_cache(maxsize=None)
def _inputs():
    """(the kNN cases, the conversion's wave and dictionary)."""
    rng = np.random.default_rng(0)
    knn = _knn_cases(rng)
    t = np.arange(F_CONV * 480) / 24000
    wave = (0.3 * np.sin(2 * np.pi * rng.uniform(90, 250, (2, 1)) * t)
            + 0.02 * rng.standard_normal((2, F_CONV * 480))).astype(np.float32)
    return knn, wave, rng.standard_normal((37, 32)).astype(np.float32)


def _jax_angle(B):
    """JAX's noise draw of ``convert_fn_sharded(key=PRNGKey(0))`` on the CPU:
    ``uniform(key, (B, F, bins), -pi, pi)`` over the global batch."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (B, F_CONV, 961),
                                         minval=-np.pi, maxval=np.pi))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of this file on two ranks: {case: [rank 0's, rank 1's]}."""
    knn, wave, dic = _inputs()
    cases, inputs = [], {}
    for name, (args, src, d) in knn.items():
        cases.append({"name": f"knn_{name}", "kind": "knn",
                      "args": {"mesh": [1, 2], "k": 4, **args}})
        inputs[f"knn_{name}"] = {"source": src, "dictionary": d}
    _, _, _, enc_p, dec_p = _model()
    cases.append({"name": "convert", "kind": "convert",
                  "args": {"mesh": [1, 2], "encoder": ENC, "decoder": DEC, "pitch": PITCH}})
    inputs["convert"] = {**flat(enc_p["params"], "enc/params/"),
                         **flat(dec_p["params"], "dec/params/"), "wave": wave,
                         "dictionary": dic, "angle": _jax_angle(wave.shape[0])}
    _, _, _, s_enc, s_dec, target, swave = _setup(np.random.default_rng(0), False, numpy_params)
    cases.append({"name": "stream", "kind": "stream",
                  "args": {"mesh": [1, 2], "encoder": S_ENC, "decoder": S_DEC, "stream": STREAM,
                           "pitch": 3.0, "seed": 5}})
    inputs["stream"] = {**flat(s_enc["params"], "enc/params/"),
                        **flat(s_dec["params"], "dec/params/"), "target": target, "wave": swave}
    return run(tmp_path_factory.mktemp("sharded"), cases, inputs, timeout=150)


@pytest.mark.parametrize("name", list(_knn_cases(np.random.default_rng(0))))
def test_sharded_match_matches_jax(ranks, name):
    args, src, dic = _inputs()[0][name]
    data, model = args.get("mesh", [1, 2])
    padded, mask = pad_dictionary(jnp.asarray(dic), model, 4)
    want = np.asarray(sharded_match_features(_mesh(data, model), jnp.asarray(src), padded, mask,
                                             k=4, alpha=args.get("alpha", 0.0),
                                             metric=args["metric"], payload=args["payload"]))
    outs = [r["out"] for r in ranks[f"knn_{name}"]]
    if data == 1:  # every rank of the model group returns the whole result
        np.testing.assert_array_equal(outs[0], outs[1])
        got = outs[0]
    else:  # each rank its rows
        got = np.concatenate(outs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=KNN_ATOL, rtol=0)
    if name.startswith("tie"):  # row 1 (shard 0) won the tie: +0.5 / 4, not row 6's -0.5 / 4
        np.testing.assert_allclose(got[0, :2, 1], 0.125, atol=KNN_ATOL, rtol=0)


def test_convert_fn_sharded_matches_jax(ranks):
    jc, E, D, enc_p, dec_p = _model()
    _, wave, dic = _inputs()
    padded, mask = pad_dictionary(jnp.asarray(dic), 2, jc.retrieval.k)
    mesh = _mesh(1, 2)
    want = np.asarray(jax.jit(lambda ep, dp, w, d, m: convert_fn_sharded(
        E, D, ep, dp, w, d, m, jnp.float32(PITCH), jax.random.PRNGKey(0), jc, mesh))(
        enc_p, dec_p, jnp.asarray(wave), padded, mask))
    outs = [r["out"] for r in ranks["convert"]]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == want.shape and np.isfinite(outs[0]).all()
    # fp32 sums in other orders through the networks: 3.6e-7 of the peak measured
    np.testing.assert_allclose(outs[0], want, atol=CONVERT_RTOL * np.abs(want).max())


class _MeshShiftSpy(_ShiftSpy):
    """`test_torch_stream._ShiftSpy` with an unordered callback: an ordered
    one is refused on more than one device (each device may report the
    replicated shift)."""

    def argmax(self, x, *args, **kwargs):
        out = jnp.argmax(x, *args, **kwargs)
        jax.debug.callback(lambda s: self.seen.append(int(s)), out)
        return out


def test_stream_with_a_mesh_matches_jax(ranks, monkeypatch):
    jc, _, _, enc_p, dec_p, target, wave = _setup(np.random.default_rng(0), False, numpy_params)
    spy = _MeshShiftSpy()
    monkeypatch.setattr(jstream, "jnp", spy)
    jsc = jstream.StreamConverter(enc_p, dec_p, target, jc, pitch_shift=3.0,
                                  key=jax.random.PRNGKey(5), mesh=_mesh(1, 2))
    r0, r1 = ranks["stream"]
    np.testing.assert_array_equal(r0["out"], r1["out"])
    np.testing.assert_array_equal(r0["shifts"], r1["shifts"])
    for b in range(BLOCKS):
        spy.seen.clear()
        want = jsc.process_block(wave[b * 480:(b + 1) * 480])
        assert len(set(spy.seen)) == 1, spy.seen
        assert int(r0["shifts"][b]) == spy.seen[0], f"block {b}: SOLA shift"
        dist = float(np.abs(r0["out"][b] - want).max() / np.abs(want).max())
        assert dist <= BLOCK_RTOL, f"block {b}: {dist:.3e} of the peak"
        print(f"block {b}: shift {spy.seen[0]}, {dist:.3e} of the peak")
