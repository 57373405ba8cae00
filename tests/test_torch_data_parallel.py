"""Data- and sequence-parallel execution of the port on two gloo ranks on
the CPU (`tests/torch_dist_worker.py`, each rank importing only the port):

- `parallel/time_shard.py::time_sharded_convert` at S=2 against the JAX
  package's on a ``make_mesh(data=2)`` mesh of the CPU's virtual devices,
  with the noise phases given;
- the encoder's data-parallel step against JAX's step on a ``data=2``
  mesh: the first step's loss and gradients, then two steps' losses,
  parameters and moments, under the single-process test's bounds
  (`tests/test_torch_encoder_train.py`);
- the decoder's pre-join step on two ranks against the port's own step on
  the global batch in one process, under the log-mel loss (the multi-scale
  STFT loss's gradient is chaotic, ROADMAP.md §3): the random draws cover
  the global batch, so the two compute the same step; after three steps
  both ranks hold the same parameters bit for bit;
- `train/loop.py::train_decoder` on two ranks saved at step 2, stopped,
  then restored on both ranks from another seed's state: step, parameters
  and moments bit-identical to the checkpoint on both ranks, one metrics
  line a step (rank 0 alone logs), and a third step leaves both ranks
  equal."""

import functools
import math
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoder_train import (GRAD_TOL, LOSS_RTOL, MOMENT_TOL, PARAM_ATOL, leaf,
                                      rel_peak)
from test_torch_fused_convert import DEC, ENC
from tests.test_training import small_config
from tinyvc_tpu import config as jcfg
from tinyvc_tpu.dsp import spectrogram as jax_spectrogram
from tinyvc_tpu.models import Decoder, Encoder, freq2id as jax_freq2id
from tinyvc_tpu.parallel import make_mesh, replicate, shard_batch
from tinyvc_tpu.parallel.time_shard import time_sharded_convert
from tinyvc_tpu.train import encoder_train as jet
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.infer.generator import exact_fp32
from tinyvc_tpu_torch.train import decoder_train as pdt
from tinyvc_tpu_torch.train import encoder_train as pet
from tinyvc_tpu_torch.utils import prng
from tinyvc_tpu_torch.utils.audio_io import load_audio, save_wav
from tinyvc_tpu_torch.utils.weights import to_jax_layout
from torch_dist import ROOT, flat, run
from torch_parity import numpy_params

F_UTT, HALO, FILTER_HALO = 48, 28, 20  # tests/test_torch_chunked.py's chunk geometry
SHARD_RTOL = 2e-4  # of the peak: the chunked path's bound against JAX's (the harmonics' cumsum)
ENC_CFG = dict(pitch_channels=16, pitch_num_layers=1, ssl_channels=16, ssl_dilations=[1],
               ssl_dim=32)  # tests/test_training.py::small_config
B_ENC, L_ENC = 4, 4800
DEC_SMALL = dict(source_channels=16, source_num_layers=1, filter_channels=[32, 24, 16, 12, 8],
                 content_channels=32)
DISC_SMALL = dict(periods=[2, 3], resolutions=[32], channels=4, max_channels=16, num_layers=2)
B_DEC, L_DEC = 4, 9600
DEC_LOSS_RTOL, DEC_LEAF_MEDIAN, DEC_LEAF_MAX = 1e-6, 1e-5, 1e-4


def _mesh(data):
    return make_mesh(data=data, model=1, devices=jax.devices()[:data])


@functools.lru_cache(maxsize=None)
def _shard_model():
    jc = jcfg.TinyVCConfig(encoder=jcfg.EncoderConfig(**ENC), decoder=jcfg.DecoderConfig(**DEC))
    E, D = Encoder(jc.encoder), Decoder(jc.decoder, jc.audio)
    enc_p = numpy_params(E, jnp.zeros((1, F_UTT, 961)))
    head = enc_p["params"]["pitch_estimator"]["stack"]["output_layer"]
    head["bias"] = head["bias"] + 8.0 * np.exp(-(((np.arange(512) - 140) / 20.0) ** 2))
    dec_p = numpy_params(D, jnp.zeros((1, F_UTT, 32)), jnp.full((1, F_UTT), 100.0),
                         jnp.zeros((1, F_UTT * 480)), jnp.zeros((2,), jnp.uint32),
                         noise_angle=jnp.zeros((1, F_UTT, 961)))
    rng = np.random.default_rng(0)
    t = np.arange(F_UTT * 480) / 24000
    wave = (0.3 * np.sin(2 * np.pi * 140.0 * t * (1 + 0.2 * t))
            + 0.02 * rng.standard_normal(F_UTT * 480)).astype(np.float32)
    target = rng.standard_normal((60, 32)).astype(np.float32)
    angle = rng.uniform(-math.pi, math.pi, (F_UTT, 961)).astype(np.float32)
    return jc, enc_p, dec_p, wave, target, angle


@functools.lru_cache(maxsize=None)
def _encoder_inputs():
    cfg = small_config()
    rng = np.random.default_rng(1)
    t = np.arange(L_ENC) / 24000
    wave = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (B_ENC, 1)) * t)
            + 0.05 * rng.standard_normal((B_ENC, L_ENC))).astype(np.float32)
    f0 = rng.uniform(60, 400, (B_ENC, L_ENC // 480)).astype(np.float32)
    f0[:, :3] = 0.0
    f0[1] = 0.0  # a row without a voiced frame: the weights' sums differ between the ranks
    teacher = (0.3 * rng.standard_normal((B_ENC, 7, 32))).astype(np.float32)
    params = numpy_params(Encoder(cfg.encoder), jnp.zeros((1, L_ENC // 480, 961)), seed=3)
    return cfg, params, wave, f0, teacher


def _decoder_wave():
    rng = np.random.default_rng(2)
    t = np.arange(L_DEC) / 24000
    wave = (0.3 * np.sin(2 * np.pi * rng.uniform(90, 250, (B_DEC, 1)) * t)
            + 0.02 * rng.standard_normal((B_DEC, L_DEC))).astype(np.float32)
    wave[1, 3000:4500] = 0.0
    return wave


def _cache(directory):
    """Five 0.4 s chunks of the demo utterance (`tests/test_torch_train_loop.py`)."""
    os.makedirs(directory)
    wave = load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))[0][0]
    for i in range(5):
        save_wav(os.path.join(directory, f"{i}.wav"), wave[7000 * i: 7000 * i + L_DEC])
        np.save(os.path.join(directory, f"{i}.f0.npy"), np.full(L_DEC // 480, 150.0, np.float32))


TRAIN_ARGS = dict(decoder=DEC_SMALL, discriminator=DISC_SMALL,
                  train=dict(batch_size=B_DEC, chunk_length=L_DEC, log_interval=1,
                             save_interval=2),
                  encoder=ENC_CFG, seed=4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of this file on two ranks, in two launches (the second
    resumes the first's checkpoint): {case: [rank 0's, rank 1's]}."""
    root = tmp_path_factory.mktemp("dp")
    _, enc_p, dec_p, wave, target, angle = _shard_model()
    _, eparams, ewave, f0, teacher = _encoder_inputs()
    cache, ckpt, logs = (str(root / n) for n in ("cache", "ckpt", "logs"))
    _cache(cache)
    train = dict(TRAIN_ARGS, cache=cache, ckpt=ckpt, logs=logs)
    cases = [
        {"name": "time_shard", "kind": "time_shard",
         "args": {"mesh": [2, 1], "encoder": ENC, "decoder": DEC, "pitch": 5.0, "seed": 3,
                  "halo": HALO, "filter_halo": FILTER_HALO}},
        {"name": "encoder_step", "kind": "encoder_step",
         "args": {"mesh": [2, 1], "encoder": ENC_CFG, "distill": True, "seed": 5, "steps": 2}},
        {"name": "decoder_step", "kind": "decoder_step",
         "args": {"mesh": [2, 1], "encoder": ENC_CFG, "decoder": DEC_SMALL, "loss": "mel",
                  "seed": 6, "steps": 3}},
        {"name": "train2", "kind": "train", "args": dict(train, steps=2)},
    ]
    inputs = {"time_shard": {**flat(enc_p["params"], "enc/params/"),
                             **flat(dec_p["params"], "dec/params/"), "wave": wave,
                             "target": target, "angle": angle},
              "encoder_step": {**flat(eparams["params"], "enc/params/"), "wave": ewave,
                               "f0": f0, "teacher": teacher},
              "decoder_step": {"wave": _decoder_wave()}}
    out = run(root / "first", cases, inputs, timeout=150)
    resume = [{"name": "restore", "kind": "restore",
               "args": dict(train, ckpt=ckpt, seed=99)},
              {"name": "train3", "kind": "train", "args": dict(train, steps=3)}]
    out.update(run(root / "second", resume, timeout=150))
    out["dirs"] = (ckpt, logs)
    return out


def test_time_sharded_convert_matches_jax(ranks):
    jc, enc_p, dec_p, wave, target, angle = _shard_model()
    mesh = _mesh(2)
    want = np.asarray(jax.jit(lambda ep, dp, w, t, a: time_sharded_convert(
        mesh, ep, dp, w, t, jnp.float32(5.0), jax.random.PRNGKey(3), jc, HALO, FILTER_HALO,
        noise_angle=a))(enc_p, dec_p, jnp.asarray(wave), jnp.asarray(target),
                        jnp.asarray(angle)))
    r0, r1 = (r["out"] for r in ranks["time_shard"])
    np.testing.assert_array_equal(r0, r1)  # every rank returns the whole waveform
    assert r0.shape == want.shape == wave.shape and np.isfinite(r0).all()
    np.testing.assert_allclose(r0, want, atol=SHARD_RTOL * np.abs(want).max())


def test_encoder_step_matches_jax_on_a_data_mesh(ranks):
    cfg, params, wave, f0, teacher = _encoder_inputs()
    r0, r1 = ranks["encoder_step"]
    key = jax.random.PRNGKey(5)
    # the first step's loss and gradients: JAX's on the global batch
    enc = Encoder(cfg.encoder)
    cw = jnp.ones((512,)).at[0].set(cfg.train.unvoiced_class_weight)
    labels = jax_freq2id(jnp.asarray(f0), 512, 48, 20.0)
    spec = jax_spectrogram(jnp.asarray(wave) * (jax.random.uniform(key, (B_ENC, 1)) * 2.0),
                           1920, 480)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jet.encoder_loss(enc, p, spec, labels, jnp.asarray(teacher), cw,
                                   cfg.train.distill_weight), has_aux=True))(params)
    for r in (r0, r1):
        assert abs(float(r["loss"]) - float(jl)) <= LOSS_RTOL * abs(float(jl))
        for k in r:
            if k.startswith("grad/"):
                name = k[len("grad/"):]
                assert rel_peak(to_jax_layout(torch.from_numpy(r[k]), name), leaf(jg, name)) \
                    <= GRAD_TOL, name
    # two steps of JAX's jitted step on the data mesh
    mesh = _mesh(2)
    st = jet.EncoderTrainState(params=params, opt_state=jet.make_optimizer(cfg).init(params),
                               step=jnp.zeros((), jnp.int32))
    st = replicate(st, mesh)
    batch = shard_batch({"wave": wave, "f0": f0, "teacher": teacher}, mesh)
    jstep = jax.jit(jet.make_train_step(cfg, True))
    losses = []
    for k in jax.random.split(key):
        st, m = jstep(st, batch["wave"], batch["f0"], batch["teacher"], k)
        losses.append(float(m["loss"]))
    st = jax.device_get(st)
    adam = st.opt_state[1][0]
    for r in (r0, r1):
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        for k in r:
            if k.startswith("param/"):
                name = k[len("param/"):]
                got = lambda pre: to_jax_layout(torch.from_numpy(r[pre + name]), name)  # noqa
                assert np.abs(got("param/") - leaf(st.params, name)).max() <= PARAM_ATOL, name
                assert rel_peak(got("mu/"), leaf(adam.mu, name)) <= MOMENT_TOL, name
                assert rel_peak(got("nu/"), leaf(adam.nu, name)) <= MOMENT_TOL, name
    for k in r0:  # every rank took the same update
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def _decoder_step(mesh=None):
    """The decoder's pre-join step as the worker builds it
    (`tests/torch_dist_worker.py::case_decoder_step`), in this process: on
    the global batch without a mesh, else on ``mesh``'s rows of it."""
    cfg = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**{**ENC_CFG, "ssl_dilations": (1,)}),
                            decoder=pcfg.DecoderConfig(**{**DEC_SMALL,
                                                          "filter_channels": (32, 24, 16, 12, 8)}))
    enc = pet.init_state(cfg, 6, "cpu").encoder.eval().requires_grad_(False)
    state = pdt.TrainState.fresh(pdt.init_state(cfg, 7, "cpu").decoder)
    step = pdt.make_train_step(cfg, False, "mel", mesh=mesh)
    wave = torch.from_numpy(_decoder_wave())
    if mesh is not None:
        wave = wave[mesh.data_index * 2:(mesh.data_index + 1) * 2]
    with exact_fp32():
        return step.loss_and_grads(state, enc, wave, prng.prng_key(8))


def test_decoder_step_on_two_ranks_is_the_global_step(ranks, monkeypatch):
    """Each rank's rows with the global batch's draws, averaged: bit for
    bit the two half-batch steps of this process averaged as the all-reduce
    averages them; within fp32 summation order of the step on the global
    batch (the split changes the order of every batch sum; measured: the
    median leaf 2.3e-6 relative L2, the worst 9.3e-6, the loss equal)."""
    torch.set_num_threads(2)  # the worker's
    r0, r1 = ranks["decoder_step"]
    monkeypatch.setattr(pdt, "data_mean", lambda mesh, *dicts: dicts)
    halves = [_decoder_step(SimpleNamespace(data=2, model=1, data_index=i)) for i in range(2)]
    monkeypatch.undo()
    loss, metrics, grads = _decoder_step()
    assert float(r0["loss"]) == float((halves[0][0] + halves[1][0]) / 2)
    errs = {}
    for name, g in grads.items():
        split = ((halves[0][2][name] + halves[1][2][name]) / 2).numpy()
        np.testing.assert_array_equal(r0["grad/" + name], split, err_msg=name)
        np.testing.assert_array_equal(r1["grad/" + name], split, err_msg=name)
        want = g.numpy()
        errs[name] = float(np.linalg.norm(split - want) / max(np.linalg.norm(want), 1e-30))
    for r in (r0, r1):
        assert abs(float(r["loss"]) - float(loss)) <= DEC_LOSS_RTOL * abs(float(loss))
        for k, v in metrics.items():
            assert abs(float(r["metric/" + k]) - float(v)) <= DEC_LOSS_RTOL * abs(float(v)), k
    worst = max(errs, key=errs.get)
    print(f"gradient leaves against the global step: median "
          f"{np.median(list(errs.values())):.2e}, worst {errs[worst]:.2e} ({worst}); loss "
          f"{abs(float(r0['loss']) - float(loss)) / abs(float(loss)):.1e}")
    assert np.median(list(errs.values())) <= DEC_LEAF_MEDIAN
    assert errs[worst] <= DEC_LEAF_MAX, worst
    for k in r0:  # three steps later both ranks hold the same parameters
        if k.startswith("param/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_checkpoint_saved_by_rank0_restores_on_every_rank(ranks):
    ckpt, logs = ranks["dirs"]
    saved = torch.load(os.path.join(ckpt, "2", "state.pt"), weights_only=False)
    trained = ranks["train2"]
    for r in range(2):
        restored = ranks["restore"][r]
        assert set(restored) == set(saved)
        assert int(restored["step"]) == saved["step"] == 2
        for k, v in saved.items():
            np.testing.assert_array_equal(restored[k], np.asarray(v), err_msg=k)
            np.testing.assert_array_equal(trained[r][k], np.asarray(v), err_msg=k)
    a, b = ranks["train3"]
    assert int(a["step"]) == int(b["step"]) == 3
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        assert [int(line.split('"step": ')[1].split(",")[0]) for line in f] == [1, 2, 3]
    assert sorted(os.listdir(ckpt)) == ["2", "3"]
