"""The port's kernel modules (`tinyvc_tpu_torch/kernels/`) against the JAX
Pallas kernels they replace, run in interpret mode on the CPU as
`tests/test_pallas.py` runs them. On CPU tensors each wrapper takes its plain
PyTorch version; the CUDA kernels themselves are held against these plain
versions on the card by `chip_smoke.py`."""

import math
import os
import re

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


def _phase_truth(f0, frame=480, sr=24000):
    """float64 phase of every sample (cycles, not wrapped), [B, L]: the
    running sum of the interpolated f0 / sr, as `_osc_truth` takes it."""
    F = f0.shape[1]
    src = np.clip((np.arange(F * frame) + 0.5) / frame - 0.5, 0, F - 1)
    j = np.floor(src).astype(int)
    fr = src - j
    f = f0.astype(np.float64)
    return np.cumsum((f[:, j] * (1 - fr) + f[:, np.minimum(j + 1, F - 1)] * fr) / sr, axis=1)


# kernel A's and I's shapes in `chip_smoke.py`: a request, serving B=8, a
# ragged batch, and 60 s
@pytest.mark.parametrize("B,F", [(1, 320), (8, 320), (3, 37), (1, 3000)])
def test_closed_form_phase_matches_truth(rng, B, F):
    """The kernels' phase (`oscillator.closed_form_phase`: the quadratic
    half-frame prefix in float64, Q0.64 frame offsets) within 1e-5 cycles of
    the float64 running sum, at any length."""
    f0 = rng.uniform(80.0, 400.0, (B, F)).astype(np.float32)
    f0[0, 5:15] = 0.0
    got = oscillator.closed_form_phase(f0)
    assert got.shape == (B, F * 480) and np.abs(got).max() <= 0.5
    d = got - _phase_truth(f0)
    err = float(np.abs(d - np.rint(d)).max())
    print(f"closed-form phase B={B} F={F}: {err:.2e} cycles from the float64 truth")
    assert err <= 1e-5


@pytest.mark.parametrize("B,F", [(2, 50), (1, 37)])
def test_closed_form_bank_matches_pallas_and_truth(rng, B, F):
    """Kernel A's arithmetic through the sine and the Chebyshev recurrence
    (`oscillator.oscillator_bank_closed_form`) against JAX's Pallas kernel
    in interpret mode within `test_oscillator_matches_pallas_and_truth`'s
    2e-2, and within 1e-4 of the float64 truth (`chip_smoke.OSC_TRUTH_ATOL`,
    the card's bound for kernel A)."""
    H1 = 15
    f0 = (np.abs(rng.standard_normal((B, F))) * 200 + 40).astype(np.float32)
    f0[0, :10] = 0.0
    amps = (np.abs(rng.standard_normal((B, F, H1))) + 0.2).clip(max=3.0).astype(np.float32)
    got = oscillator.oscillator_bank_closed_form(torch.from_numpy(f0),
                                                 torch.from_numpy(amps)).numpy()
    pallas = np.asarray(j_oscillator_bank(
        jnp.asarray(f0), jnp.asarray(amps), 480, 24000, 20.0,
        interpret=True, transpose_out=False,
    ))
    truth = _osc_truth(f0, amps)
    err_pallas, err_truth = np.abs(got - pallas).max(), np.abs(got - truth).max()
    print(f"closed-form bank B={B} F={F}: vs Pallas {err_pallas:.2e}, vs truth {err_truth:.2e}")
    assert got.shape == pallas.shape == (B, H1, F * 480)
    assert err_pallas < 2e-2 and err_truth <= 1e-4


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


@pytest.mark.parametrize("factor", (2, 3, 4, 5, 64))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_resample_grad_launch_takes_the_plain_tap_table(monkeypatch, factor, dtype):
    """Kernel J's wrapper, its launch intercepted: in up mode it passes a
    [2*factor, 4] fp32 table, the band weights of the plain version's tent
    (rounded to bf16 for a bf16 cotangent, as `upsample_linear_grad_plain`
    rounds them), then the clamped edges' weights in fp32, never rounded,
    each row with a zero fourth column; in down mode no table."""
    from tinyvc_tpu_torch.dsp.interp import _tent_weights

    calls = []
    monkeypatch.setattr(resample.build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(resample.build, "check_input", lambda *a, **kw: None)
    monkeypatch.setattr(resample.build, "launch", lambda name, t, *args: calls.append((name, args)))
    for counter in ("launches", "launches_bf16"):  # restored after the test
        monkeypatch.setattr(resample.resample_grad, counter,
                            getattr(resample.resample_grad, counter))
    out = resample.resample_grad(torch.zeros((3, 7 * factor), dtype=dtype), 7, factor, True)
    down = resample.resample_grad(torch.zeros((3, 7), dtype=dtype), 7 * factor, factor, False)
    [(name, (g, w, gx, R, T, f, up, bf16)), (_, (_, w_down, gx_down, *rest))] = calls
    assert name == "tvc_resample_grad" and gx is out and out.shape == (3, 7)
    assert (R, T, f, up, bf16) == (3, 7, factor, 1, int(dtype == torch.bfloat16))
    assert w_down is None and gx_down is down and rest[:4] == [3, 7 * factor, factor, 0]
    edge = torch.from_numpy(_tent_weights(factor)).T
    band = edge.to(torch.bfloat16).float() if dtype == torch.bfloat16 else edge
    assert w.shape == (2 * factor, 4) and w.dtype == torch.float32 and w.is_contiguous()
    assert torch.equal(w[:factor, :3], band) and torch.equal(w[factor:, :3], edge)
    assert not w[:, 3].any()


def _resample_cu_const(name):
    src = open(os.path.join(os.path.dirname(resample.__file__), "csrc", "resample.cu")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _grad_stores(rows, T, f, up, isz):
    """Kernel J's schedule, as `csrc/resample.cu::dispatch_grad` and its
    kernels compute it for a 16-byte aligned cotangent: (path, the flat
    [start, end) of gx that each store covers); for the up-mode run path it
    also checks that each thread's window of staged vectors holds the
    samples its outputs read, and that its block loaded them."""
    nt, V = _resample_cu_const("UP_THREADS"), 16 // isz
    total = rows * T
    run = lambda F: V // math.gcd(V, F) * F
    if up and 2 <= f <= 5 and T % V == 0:
        HV = -(-f // V)
        q = np.arange(0, total, V, dtype=np.int64)  # each thread's first output
        q0 = q // (nt * V) * (nt * V)  # its block's
        t = (q - q0) // V
        nq = np.minimum(nt * V, total - q0)
        v0, nst = q0 // V * f - HV, nq // V * f + 2 * HV
        assert (t * f + f + 2 * HV <= nst).all()  # its window lies in what the block staged
        # the cotangent its outputs read: their own samples and their in-row neighbours'
        i0 = q % T
        lo = q * f - np.where(i0 > 0, f, 0)
        hi = (q + V) * f + np.where(i0 + V < T, f, 0)
        assert ((v0 + t * f) * V <= lo).all() and (hi <= (v0 + t * f + f + 2 * HV) * V).all()
        # ... and the block loaded it (staged vectors inside the cotangent)
        assert (lo // V >= np.maximum(v0, 0)).all()
        assert (-(-hi // V) <= np.minimum(v0 + nst, total // V * f)).all()
        return "run", np.stack([q, q + V], 1)
    if not up and 3 <= f <= 5 and T % run(f) == 0:
        U = run(f)
        runs = total // U
        if U == V:  # each thread stores its run
            s = np.arange(runs, dtype=np.int64) * U
            return "run", np.stack([s, s + U], 1)
        spans = []
        for b0 in range(0, runs, nt):  # the block stores its runs' vectors
            nv = min(runs - b0, nt) * (U // V)
            s = b0 * U + np.arange(nv, dtype=np.int64) * V
            spans.append(np.stack([s, s + V], 1))
        return "run", np.concatenate(spans)
    s = np.arange(0, total, V, dtype=np.int64)
    return "vector", np.stack([s, np.minimum(s + V, total)], 1)


# the pre-join step's four calls (B=16), then shapes for the vector path
# (T not a multiple of the vector or the run, T = 1, one row, f = 64) and
# run shapes whose last block is partial
@pytest.mark.parametrize("rows,T,f,up", [(384, 48000, 5, False), (768, 9600, 4, False),
                                         (768, 2400, 4, True), (384, 9600, 5, True),
                                         (5, 37, 3, True), (5, 111, 4, False), (3, 1, 3, True),
                                         (1, 333, 5, True), (2, 13, 64, True), (1, 5, 5, False),
                                         (7, 64, 2, True), (4, 24, 3, False), (2, 120, 3, False),
                                         (3, 48, 5, False), (1, 40, 5, True)])
@pytest.mark.parametrize("isz", (4, 2))
def test_resample_grad_paths_cover_every_output_once(rows, T, f, up, isz):
    """Kernel J's run and vector paths write every gx element exactly once
    (each store of the run path a whole 16-byte vector), and each up-mode
    run thread finds its samples in what its block staged. The step's four
    shapes take the run path in both precisions."""
    path, spans = _grad_stores(rows, T, f, up, isz)
    order = np.argsort(spans[:, 0])
    spans = spans[order]
    assert spans[0, 0] == 0 and spans[-1, 1] == rows * T
    assert (spans[1:, 0] == spans[:-1, 1]).all()  # no gap, no overlap
    V = 16 // isz
    if path == "run":
        assert ((spans[:, 1] - spans[:, 0]) % V == 0).all() and (spans[:, 0] % V == 0).all()
    if rows >= 384:
        assert path == "run"


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4)
    with pytest.raises(ValueError):
        resample.upsample_linear(x.to("meta"), 2)
