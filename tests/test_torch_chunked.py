"""Chunked long-form conversion against `tinyvc_tpu` on the CPU, at small
widths: GRN's halo and chunk-row statistic, the oscillator's ``phase0``
seed (the plain version and kernel A's closed-form mirror), the
per-global-frame noise table, the fused U-Net's ``kernel_min_len`` and the
whole chunked pipeline (`parallel/time_shard.py::time_batched_convert`
against JAX's ``_time_batched_native``, whose Pallas U-Net kernels run in
interpret mode), and its invariance to the chunk count."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_convert import DEC, ENC, _small
from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models import Decoder as JDecoder
from tinyvc_tpu.dsp.interp import upsample_frames_to_samples as j_upsample_frames_to_samples
from tinyvc_tpu.models import Encoder
from tinyvc_tpu.models.decoder import oscillate_harmonics as j_oscillate_harmonics
from tinyvc_tpu.models.layers import GRN as JGRN
from tinyvc_tpu.ops.fused_filternet import filternet_fused_apply as j_filternet_fused_apply
from tinyvc_tpu.parallel.time_shard import _per_frame_angles, _time_batched_native
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.dsp.synth import oscillate_harmonics
from tinyvc_tpu_torch.infer import generator
from tinyvc_tpu_torch.infer.generator import VoiceConverter, exact_fp32
from tinyvc_tpu_torch.kernels import oscillator
from tinyvc_tpu_torch.models.decoder import fused_pack_width, pack_source
from tinyvc_tpu_torch.models.layers import GRN, grn_time_chunks
from tinyvc_tpu_torch.ops.fused_filternet import filternet_fused_apply
from tinyvc_tpu_torch.parallel import time_shard
from tinyvc_tpu_torch.utils import prng
from tinyvc_tpu_torch.utils.weights import decoder_from_jax, encoder_from_jax

F_UTT, HALO, FILTER_HALO = 48, 28, 20  # M = 24 frames of source margin, H >= M + 2


@functools.lru_cache(maxsize=None)
def _model():
    """`_small`'s JAX config, modules and parameters, drawn once for the
    file: its draws depend on neither the frame count nor the rng."""
    return _small(None, F_UTT)


@pytest.mark.parametrize("halo,batch", [(0, False), (3, False), (3, True), (0, True)])
def test_grn_time_halo_and_batch_reduce_match_jax(rng, halo, batch):
    x = rng.standard_normal((3, 20, 8)).astype(np.float32)
    gamma, beta = (0.3 * rng.standard_normal(8).astype(np.float32) for _ in range(2))
    want = JGRN(time_halo=halo, time_batch_reduce=batch).apply(
        {"params": {"gamma": gamma, "beta": beta}}, jnp.asarray(x))
    grn = GRN(8, time_halo=halo, time_batch_reduce=batch)
    with torch.no_grad():
        grn.gamma.copy_(torch.from_numpy(gamma))
        grn.beta.copy_(torch.from_numpy(beta))
        got = grn(torch.from_numpy(x)).numpy()
    # fp32 sums of at most 60 squares in another order: 1e-6 relative
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    if halo == 0 and not batch:  # the defaults: the whole-utterance statistic, bit for bit
        ref = torch.from_numpy(x)
        gx = torch.sqrt(torch.sum(ref * ref, dim=-2, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        np.testing.assert_array_equal(
            got, (grn.gamma.detach() * (ref * nx) + grn.beta.detach() + ref).numpy())


def test_modules_take_the_chunk_settings_as_jax(rng):
    """The port's ``Encoder`` and ``SourceNet`` under `grn_time_chunks` (the
    converter's route) against JAX's modules built with
    ``time_halo``/``time_batch``, the settings restored afterwards; the
    seeded harmonics of kernel A's wrapper (`oscillator_bank(phase0=)`,
    the chunked path's call) against JAX's oscillator seeded so, times the
    amplitudes as JAX's ``Decoder.dsp`` multiplies them."""
    jc, E, D, enc_p, dec_p = _model()
    spec = np.abs(rng.standard_normal((3, 24, 961))).astype(np.float32)
    j_enc = Encoder(jc.encoder, time_halo=4, time_batch=True)
    want_c, want_f0 = jax.jit(lambda p, x: j_enc.apply(p, x, method=j_enc.infer))(enc_p, spec)
    enc = encoder_from_jax(enc_p, pcfg.EncoderConfig(**ENC))
    with torch.no_grad():
        with grn_time_chunks(enc, 4, True):
            got_c, got_f0 = enc.infer(torch.from_numpy(spec))
        whole_c, _ = enc.infer(torch.from_numpy(spec))
    # the encoder's bound of tests/test_torch_modules.py::test_encoder_infer
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               atol=1e-4 * np.abs(np.asarray(want_c)).max())
    np.testing.assert_allclose(got_f0.numpy(), np.asarray(want_f0), rtol=1e-4, atol=1e-3)
    assert all((g.time_halo, g.time_batch_reduce) == (0, False)
               for g in enc.modules() if isinstance(g, GRN))
    assert np.abs(whole_c.numpy() - got_c.numpy()).max() > 1e-3  # the settings come back

    B, F = 3, 12
    content = rng.standard_normal((B, F, 32)).astype(np.float32)
    f0 = rng.uniform(80, 300, (B, F)).astype(np.float32)
    energy = rng.uniform(0, 0.5, (B, F * 480)).astype(np.float32)
    j_dec = JDecoder(jc.decoder, jc.audio, time_halo=2, time_batch=True)
    want_a, want_k = jax.jit(lambda p, c, f, e: j_dec.apply(
        p, c, f, e, method=lambda m, c, f, e: m.source_net(c, f, e)))(dec_p, content, f0, energy)
    dec = decoder_from_jax(dec_p, pcfg.DecoderConfig(**DEC))
    with torch.no_grad(), grn_time_chunks(dec.source_net, 2, True):
        amps, kern = dec.source_net(*(torch.from_numpy(x) for x in (content, f0, energy)))
    # SourceNet's bound of tests/test_torch_modules.py::test_source_net_and_dsp
    np.testing.assert_allclose(amps.numpy(), np.asarray(want_a), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(kern.numpy(), np.asarray(want_k), rtol=1e-4, atol=1e-5)

    phase0 = rng.uniform(0, 1, B).astype(np.float32)
    j_amps = np.array(want_a)
    want = np.asarray(j_oscillate_harmonics(jnp.asarray(f0), 480, 24000, j_amps.shape[-1] - 1,
                                            20.0, phase0=jnp.asarray(phase0))
                      * j_upsample_frames_to_samples(jnp.asarray(j_amps), 480))
    got = oscillator.oscillator_bank(torch.from_numpy(f0), torch.from_numpy(j_amps),
                                     phase0=torch.from_numpy(phase0)).numpy()
    # the harmonics' bound of tests/test_torch_modules.py::test_source_net_and_dsp:
    # XLA's parallel-prefix cumsum against torch's sequential one
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=2e-4 * float(j_amps.max()))


def test_oscillate_harmonics_phase0_matches_jax(rng):
    B, F = 3, 24
    f0 = rng.uniform(80.0, 400.0, (B, F)).astype(np.float32)
    f0[1, 4:9] = 0.0
    phase0 = rng.uniform(0.0, 1.0, B).astype(np.float32)
    want = np.asarray(j_oscillate_harmonics(jnp.asarray(f0), 480, 24000, 4, 20.0,
                                            phase0=jnp.asarray(phase0)))
    got = oscillate_harmonics(torch.from_numpy(f0), 480, 24000, 4, 20.0,
                              torch.from_numpy(phase0)).numpy()
    # the same two-level scheme; XLA's cumsum is a parallel prefix and
    # torch's sequential: the unit harmonics' bound of
    # tests/test_torch_modules.py::test_source_net_and_dsp, 2e-4
    np.testing.assert_allclose(got, want, atol=2e-4)
    unseeded = oscillate_harmonics(torch.from_numpy(f0), 480, 24000, 4, 20.0).numpy()
    assert np.abs(got - unseeded).max() > 0.1  # the seed moves the phase


def test_closed_form_phase0_matches_truth_and_none_is_zero(rng):
    """Kernel A's arithmetic with a seed (`closed_form_phase`, the seed
    wrapped to Q0.64 and added to the frame offsets) against the float64
    running phase plus the seed, at a chunk row's 586 frames; no seed is
    a seed of 0, bit for bit."""
    B, F = 2, 586
    f0 = rng.uniform(80.0, 400.0, (B, F)).astype(np.float32)
    phase0 = np.array([0.8125, 0.3], np.float32)
    got = oscillator.closed_form_phase(f0, phase0=phase0)
    L = F * 480
    src = np.clip((np.arange(L) + 0.5) / 480 - 0.5, 0, F - 1)
    j = np.floor(src).astype(int)
    fr = src - j
    f = f0.astype(np.float64)
    truth = np.cumsum((f[:, j] * (1 - fr) + f[:, np.minimum(j + 1, F - 1)] * fr) / 24000, axis=1)
    d = got - (truth + phase0.astype(np.float64)[:, None])
    # float64 sums over 281,280 samples: 1e-9 cycles
    assert np.abs(d - np.rint(d)).max() < 1e-9
    np.testing.assert_array_equal(oscillator.closed_form_phase(f0),
                                  oscillator.closed_form_phase(f0, phase0=np.zeros(B, np.float32)))
    amps = torch.from_numpy((np.abs(rng.standard_normal((B, 6, 3))) + 0.1).astype(np.float32))
    f0s = torch.from_numpy(f0[:, :6])
    seeded = oscillator.oscillator_bank_closed_form(f0s, amps, phase0=torch.from_numpy(phase0))
    plain = oscillator.oscillator_bank(f0s, amps, phase0=torch.from_numpy(phase0))
    # the mirror against the plain version over 6 frames: the plain
    # version's fp32 phase, times harmonic 3 and the amplitude
    np.testing.assert_allclose(seeded.numpy(), plain.numpy(), atol=1e-4)


def test_per_frame_angles_match_jax_bit_for_bit():
    frames = np.concatenate([np.arange(-40, 30), [2**31 - 1, -(2**31), 123456]]).astype(np.int32)
    for seed in (0, 7):
        want = np.asarray(_per_frame_angles(jax.random.PRNGKey(seed), jnp.asarray(frames), 961))
        key = prng.prng_key(seed)
        got = prng.per_frame_angles(key, frames, 961)
        assert got.dtype == np.float32 and got.shape == (frames.size, 961)
        np.testing.assert_array_equal(got, want)
        on_device = prng.per_frame_angles_torch(key, torch.from_numpy(frames.astype(np.int64)), 961)
        np.testing.assert_array_equal(on_device.numpy(), got)
        np.testing.assert_array_equal(
            prng.fold_in(key, frames[:3]),
            np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
                jax.random.PRNGKey(seed), jnp.int32(i)))) for i in frames[:3]]))


def test_fused_unet_kernel_min_len_matches_jax(rng):
    """At 20 frames (9,600 samples) the stem and the last up stage reach
    8,192 positions and run the chain kernels' plain versions; every other
    stage runs its module."""
    F, B = 20, 1
    jc, E, D, enc_p, dec_p = _model()
    fn_params = dec_p["params"]["filter_net"]
    L = F * 480
    content = rng.standard_normal((B, F, 32)).astype(np.float32)
    f0 = rng.uniform(80.0, 300.0, (B, F)).astype(np.float32)
    energy = (0.1 * np.abs(rng.standard_normal((B, L)))).astype(np.float32)
    source = (0.3 * rng.standard_normal((B, L, DEC["num_harmonics"] + 2))).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, *x: j_filternet_fused_apply(
        p, jc.decoder, *x, interpret=True, kernel_min_len=8192))(
        fn_params, jnp.asarray(content), jnp.asarray(f0), jnp.asarray(energy),
        jnp.asarray(source)))
    dec = decoder_from_jax(dec_p, pcfg.DecoderConfig(**DEC))
    packed = np.concatenate([source.transpose(0, 2, 1), energy[:, None], np.zeros((B, 1, L),
                                                                                  np.float32)], 1)
    with torch.inference_mode():
        got = {k: filternet_fused_apply(
            dec.filter_net, pcfg.DecoderConfig(**DEC), torch.from_numpy(content),
            torch.from_numpy(f0), torch.from_numpy(energy), torch.from_numpy(packed),
            kernel_min_len=k).numpy() for k in (0, 8192)}
    peak = np.abs(want).max()
    # the U-Net's bound against JAX, tests/test_torch_filter_stage.py: 1e-5 of the peak
    np.testing.assert_allclose(got[8192], want, atol=1e-5 * peak)
    # the modules pad each conv where the chains pad their input: another
    # result (kernel_min_len=0 is held to JAX by tests/test_torch_fused_convert.py)
    assert np.abs(got[0] - got[8192]).max() > 100 * 1e-5 * peak


def test_filter_infer_packs_the_source_for_its_route(rng):
    """`filter_infer`, the U-Net step shared by whole and chunked
    conversion: "off" (and "auto" on the CPU) filters ``[harmonics;
    noise]`` with the layer-by-layer U-Net; "on" packs the energy row and
    zero rows up to `fused_pack_width` and runs the fused U-Net with the
    given ``kernel_min_len``, bit for bit the direct calls."""
    F, B = 20, 2
    _, _, _, _, dec_p = _model()
    dec = decoder_from_jax(dec_p, pcfg.DecoderConfig(**DEC))
    L, n_src = F * 480, DEC["num_harmonics"] + 2
    content, f0, energy, harm, noise = (torch.from_numpy(x.astype(np.float32)) for x in (
        rng.standard_normal((B, F, 32)), rng.uniform(80.0, 300.0, (B, F)),
        0.1 * np.abs(rng.standard_normal((B, L))), 0.3 * rng.standard_normal((B, n_src - 1, L)),
        0.3 * rng.standard_normal((B, L))))
    assert [fused_pack_width(n) for n in (6, 7, 8, 15)] == [8, 8, 16, 16]
    packed = pack_source(harm, noise, energy)
    assert packed.shape == (B, fused_pack_width(n_src), L)
    np.testing.assert_array_equal(packed[:, :n_src - 1].numpy(), harm.numpy())
    np.testing.assert_array_equal(packed[:, n_src - 1].numpy(), noise.numpy())
    np.testing.assert_array_equal(packed[:, n_src].numpy(), energy.numpy())
    np.testing.assert_array_equal(packed[:, n_src + 1:].numpy(), 0.0)
    source = pack_source(harm, noise)
    np.testing.assert_array_equal(source.numpy(), packed[:, :n_src].numpy())

    def run(flag, k=0):
        cfg = pcfg.TinyVCConfig(decoder=pcfg.DecoderConfig(**DEC, use_fused_filter=flag))
        with torch.inference_mode():
            return generator.filter_infer(dec, content, f0, energy, harm, noise, cfg,
                                          kernel_min_len=k)

    with torch.inference_mode():
        layered = dec.filter_net(content, f0, energy, source)
        fused = {k: filternet_fused_apply(dec.filter_net, pcfg.DecoderConfig(**DEC), content, f0,
                                          energy, packed, kernel_min_len=k) for k in (0, 8192)}
    for flag in ("off", "auto"):
        out, src = run(flag)
        np.testing.assert_array_equal(out.numpy(), layered.numpy())
        np.testing.assert_array_equal(src.numpy(), source.numpy())
    for k in (0, 8192):
        out, src = run("on", k)
        np.testing.assert_array_equal(out.numpy(), fused[k].numpy())
        np.testing.assert_array_equal(src.numpy(), source.numpy())
    with pytest.raises(ValueError, match="use_fused_filter"):
        run("maybe")


def _pipeline(rng):
    jc, E, D, enc_p, dec_p = _model()
    t = np.arange(F_UTT * 480) / 24000
    wave = (0.3 * np.sin(2 * np.pi * 140.0 * t * (1 + 0.2 * t))
            + 0.02 * rng.standard_normal(F_UTT * 480)).astype(np.float32)
    target = rng.standard_normal((60, 32)).astype(np.float32)
    angle = rng.uniform(-math.pi, math.pi, (F_UTT, 961)).astype(np.float32)
    return jc, enc_p, dec_p, wave, target, angle


def _port_chunked(enc_p, dec_p, wave, target, angle, flag, S, seed=3):
    cfg = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC),
                            decoder=pcfg.DecoderConfig(**DEC, use_fused_filter=flag))
    with torch.inference_mode(), exact_fp32():
        out = time_shard.time_batched_convert(
            encoder_from_jax(enc_p, cfg.encoder), decoder_from_jax(dec_p, cfg.decoder, cfg.audio),
            torch.from_numpy(wave), torch.from_numpy(target), 5.0, prng.prng_key(seed), cfg,
            shards=S, halo_frames=HALO, filter_halo=FILTER_HALO,
            noise_angle=None if angle is None else torch.from_numpy(angle))
    return out.numpy()


# (U-Net, S, explicit angle): "off" is the layer-by-layer U-Net at S = 1,
# 2 and 4, with and without the angle; "on" the fused one with
# kernel_min_len=8192 (the last up stage's 28,800+ samples on the chain
# kernel, the rest on the modules), with and without. Each case compiles
# JAX's pipeline anew (~7 s on the CPU), so each axis value is covered
# once per U-Net route, not every product.
CASES = [("off", 1, True), ("off", 4, True), ("off", 2, False),
         ("on", 2, True), ("on", 4, False)]


@pytest.mark.parametrize("flag,S,with_angle", CASES)
def test_time_batched_matches_jax(rng, flag, S, with_angle):
    jc0, enc_p, dec_p, wave, target, angle = _pipeline(rng)
    jc = jcfg.TinyVCConfig(encoder=jc0.encoder,
                           decoder=jcfg.DecoderConfig(**DEC, use_fused_filter=flag))
    angle = angle if with_angle else None
    want = np.asarray(jax.jit(lambda ep, dp, w, t, a: _time_batched_native(
        ep, dp, w, t, jnp.float32(5.0), jax.random.PRNGKey(3), jc, S, HALO, FILTER_HALO, a))(
        enc_p, dec_p, jnp.asarray(wave), jnp.asarray(target),
        None if angle is None else jnp.asarray(angle)))
    got = _port_chunked(enc_p, dec_p, wave, target, angle, flag, S)
    assert got.shape == want.shape == wave.shape and np.isfinite(got).all()
    # the whole-utterance bound of tests/test_torch_fused_convert.py: the
    # harmonics' cumsum order (XLA's parallel prefix against torch's
    # sequential sum) drifts the phase along each row, into the waveform:
    # 2e-4 of the peak. Without an angle the noise tables are equal bit
    # for bit (test_per_frame_angles_match_jax_bit_for_bit).
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_chunk_count_invariance(rng):
    """S=2 against S=4 on the same utterance and noise table: the GRN
    statistic, the phase seeds and the noise indexing make the result
    independent of the chunking."""
    _, enc_p, dec_p, wave, target, angle = _pipeline(rng)
    outs = {S: _port_chunked(enc_p, dec_p, wave, target, None, "off", S) for S in (2, 4)}
    rel = np.abs(outs[2] - outs[4]).max() / np.abs(outs[2]).max()
    # JAX's own bound for its chunk counts (tests/test_time_shard.py:92)
    assert rel < 5e-2, rel
    # what the port shows here: fp32 noise only
    assert rel < 1e-3, rel


def test_convert_chunked_buckets_and_cuts(rng):
    """``S = ceil(F / chunk_frames)``, the wave zero-padded to ``S *
    chunk_frames`` frames, the output cut to the input's length; a halo
    longer than the utterance takes the edge-repeat pad."""
    jc, enc_p, dec_p, wave, target, _ = _pipeline(rng)
    cfg = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC), decoder=pcfg.DecoderConfig(**DEC))
    vc = VoiceConverter(enc_p, dec_p, cfg, device="cpu")
    x = wave[:17 * 480 + 100]  # 18 frames
    st = {}
    out = vc.convert_chunked(x, target, 5.0, chunk_frames=8, halo_frames=HALO,
                             filter_halo=FILTER_HALO, stages=st)
    assert out.shape == x.shape and np.isfinite(out).all()
    assert st["f0"].shape == (3, 8 + 2 * HALO)  # S = ceil(18 / 8) = 3 rows
    padded = np.zeros(24 * 480, np.float32)
    padded[:x.size] = x
    with torch.inference_mode(), exact_fp32():
        want = time_shard.time_batched_convert(
            vc.encoder, vc.decoder, torch.from_numpy(padded), torch.from_numpy(target), 5.0,
            prng.prng_key(0), cfg, shards=3, halo_frames=HALO, filter_halo=FILTER_HALO)
    np.testing.assert_array_equal(out, want[:x.size].numpy())
    with pytest.raises(ValueError, match="halo_frames"):
        vc.convert_chunked(x, target, chunk_frames=8, halo_frames=10, filter_halo=FILTER_HALO)
