"""The port's kernel modules (`tinyvc_tpu_torch/kernels/`) against the JAX
Pallas kernels they replace, run in interpret mode on the CPU as
`tests/test_pallas.py` runs them. On CPU tensors each wrapper takes its plain
PyTorch version; the CUDA kernels themselves are held against these plain
versions on the card by `chip_smoke.py`."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu.dsp.interp import upsample_frames_to_samples as j_upsample_frames
from tinyvc_tpu.models import oscillate_harmonics as j_oscillate_harmonics
from tinyvc_tpu.ops.pallas.noise import _murmur_mix, pallas_oscillate_noise
from tinyvc_tpu.ops.pallas.oscillator import oscillator_bank as j_oscillator_bank
from tinyvc_tpu.ops.pallas.resample import pallas_upsample_t
from tinyvc_tpu_torch.kernels import noise, oscillator, resample


def _osc_truth(f0, amps, frame=480, sr=24000, fmin=20.0):
    """float64 ground truth of oscillate_harmonics * interp(amps), [B, H1, L]."""
    B, F = f0.shape
    L = F * frame
    src = np.clip((np.arange(L) + 0.5) / frame - 0.5, 0, F - 1)
    j = np.floor(src).astype(int)
    j1 = np.minimum(j + 1, F - 1)
    fr = src - j

    def interp(x):
        return x[:, j] * (1 - fr) + x[:, j1] * fr

    phase = np.cumsum(interp(f0.astype(np.float64)) / sr, axis=1)
    uv = interp((f0 > fmin).astype(np.float64))
    k = np.arange(1, amps.shape[-1] + 1)
    harm = np.sin(2 * np.pi * np.mod(phase[:, :, None] * k, 1.0)) * uv[:, :, None]
    amps_w = np.stack([interp(amps[:, :, h].astype(np.float64)) for h in range(amps.shape[-1])], -1)
    return np.transpose(harm * amps_w, (0, 2, 1))


# F=50 has an unvoiced run; F=37 is not a multiple of the Pallas kernel's
# 24-frame block, so its padded tail is exercised.
@pytest.mark.parametrize("B,F", [(2, 50), (1, 37)])
def test_oscillator_matches_pallas_and_truth(rng, B, F):
    H1 = 15
    f0 = (np.abs(rng.standard_normal((B, F))) * 200 + 40).astype(np.float32)
    f0[0, :10] = 0.0
    amps = (np.abs(rng.standard_normal((B, F, H1))) + 0.2).astype(np.float32)
    truth = _osc_truth(f0, amps)

    pallas = np.asarray(j_oscillator_bank(
        jnp.asarray(f0), jnp.asarray(amps), 480, 24000, 20.0,
        interpret=True, transpose_out=False,
    ))
    xla = j_oscillate_harmonics(jnp.asarray(f0), 480, 24000, H1 - 1, 20.0)
    xla = np.transpose(np.asarray(xla * j_upsample_frames(jnp.asarray(amps), 480)), (0, 2, 1))
    port = oscillator.oscillator_bank(torch.from_numpy(f0), torch.from_numpy(amps)).numpy()
    assert port.shape == pallas.shape == (B, H1, F * 480)

    err_port = np.abs(port - truth).max()
    err_pallas = np.abs(pallas - truth).max()
    err_xla = np.abs(xla - truth).max()
    # 2e-2: the bound `tests/test_pallas.py` holds the Pallas kernel to
    # (fp32 phase integration over the utterance, times harmonic 15)
    assert err_port < 2e-2 and err_pallas < 2e-2, (err_port, err_pallas)
    # the port's plain version is the XLA scheme: no worse than 1.5x its error
    assert err_port <= 1.5 * err_xla + 1e-6, (err_port, err_xla)
    assert oscillator.oscillator_bank.launches == 0


def _jax_hash_angles(B, F, bins, seed, rows_total):
    """The Pallas noise kernel's phase arithmetic (`noise.py:141-151`),
    evaluated with JAX ops on the kernel's own index layout."""
    b = jnp.arange(B, dtype=jnp.int32)[:, None, None]
    p = jnp.arange(F, dtype=jnp.int32)[None, :, None] + 2
    k = jnp.arange(bins, dtype=jnp.int32)[None, None, :]
    idx = (b * rows_total + p) * 1024 + k
    h = _murmur_mix(idx.astype(jnp.uint32) ^ jnp.asarray(seed, jnp.int32).astype(jnp.uint32))
    u = (h >> jnp.uint32(9)).astype(jnp.int32).astype(jnp.float32) * jnp.float32(2.0**-23)
    return np.asarray(u * jnp.float32(2.0 * np.pi) - jnp.float32(np.pi))


def _jax_rows_total(F):
    """`pallas_oscillate_noise`'s padded row count, transcribed."""
    t = 128
    for cand in range(128, 7, -8):
        if F % cand == 0:
            t = cand
            break
    nt = -(-F // t)
    rows = t + 3 + (-(t + 3)) % 8
    return max(2 + F, (nt - 1) * t + rows)


# primes, multiples of 8, multiples of 128, and F above one 128-row tile
@pytest.mark.parametrize("F", [7, 37, 41, 64, 96, 128, 131, 320, 1000])
def test_noise_hash_angles_bit_exact(F):
    B, bins = 3, 961
    for seed in (0, 7, -5, 2**31 - 1):
        want = _jax_hash_angles(B, F, bins, seed, _jax_rows_total(F))
        got = noise.noise_angles(B, F, bins, seed).numpy()
        assert noise.rows_total(F) == _jax_rows_total(F)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("B,F", [(2, 37), (1, 64)])
def test_noise_matches_pallas(rng, B, F):
    bins = 961
    mag = np.abs(rng.standard_normal((B, F, bins))).astype(np.float32)
    ang = rng.uniform(-math.pi, math.pi, (B, F, bins)).astype(np.float32)
    tmag = torch.from_numpy(mag)
    # 1e-5: `tests/test_pallas.py`'s bound for the fp32 kernel against the
    # istft (outputs have std ~0.03; this is fp32 summation order)
    want = np.asarray(pallas_oscillate_noise(
        jnp.asarray(mag), 7, angle=jnp.asarray(ang), interpret=True, dtype_name="float32"))
    got = noise.oscillate_noise_hashed(tmag, 7, angle=torch.from_numpy(ang)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # seed mode: the same hashed phases, so the same noise
    want = np.asarray(pallas_oscillate_noise(
        jnp.asarray(mag), 7, interpret=True, dtype_name="float32"))
    got = noise.oscillate_noise_hashed(tmag, 7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert noise.oscillate_noise_hashed.launches == 0


# the energy upsample, ragged U-Net-like rows, and kernel C's edge cases:
# rows of T*f not a multiple of its 16-byte vector (111, 26, 185, 1665),
# T = 1, one row
@pytest.mark.parametrize("R,T,factor", [(1, 2400, 64), (3, 37, 64), (2, 50, 5), (1, 37, 3),
                                        (5, 13, 2), (3, 37, 5), (2, 1, 4), (1, 1, 2),
                                        (1, 333, 5)])
def test_upsample_matches_pallas(rng, R, T, factor):
    x = rng.uniform(0.0, 1.0, (R, T)).astype(np.float32)
    want = np.asarray(pallas_upsample_t(jnp.asarray(x[None]), factor, interpret=True))
    want = want[0, :, : factor * T]
    got = resample.upsample_linear(torch.from_numpy(x), factor).numpy()
    assert got.shape == (R, factor * T)
    # 1e-6: one fp32 rounding of a two-tap sum of values <= 1 (band matmul
    # against the tent form)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert resample.upsample_linear.launches == 0


@pytest.mark.parametrize("factor", (2, 3, 5, 64))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_upsample_launch_takes_the_plain_tap_table(monkeypatch, factor, dtype):
    """Kernel C's wrapper, its launch intercepted: it passes a [factor, 4]
    fp32 table of the plain version's tent weights (rounded to bf16 for a
    bf16 x, as the plain version rounds them), a zero fourth column, and
    the output it returns."""
    from tinyvc_tpu_torch.dsp.interp import _tent_weights

    calls = []
    monkeypatch.setattr(resample.build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(resample.build, "check_input", lambda *a, **kw: None)
    monkeypatch.setattr(resample.build, "launch", lambda name, t, *args: calls.append((name, args)))
    # the counters are restored after the test: other tests expect them at 0
    for counter in ("launches", "launches_bf16"):
        monkeypatch.setattr(resample.upsample_linear, counter,
                            getattr(resample.upsample_linear, counter))
    out = resample.upsample_linear(torch.zeros((3, 7), dtype=dtype), factor)
    [(name, (_, w, y, R, T, f, bf16))] = calls
    assert name == "tvc_upsample_linear" and y is out and out.shape == (3, 7 * factor)
    assert (R, T, f, bf16) == (3, 7, factor, int(dtype == torch.bfloat16))
    want = torch.from_numpy(_tent_weights(factor)).T
    if dtype == torch.bfloat16:
        want = want.to(torch.bfloat16).float()
    assert w.shape == (factor, 4) and w.dtype == torch.float32 and w.is_contiguous()
    assert torch.equal(w[:, :3], want) and not w[:, 3].any()


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4)
    with pytest.raises(ValueError):
        resample.upsample_linear(x.to("meta"), 2)
