"""The FFT of kernels G and B (`tinyvc_tpu_torch/kernels/fft.py`, the plain
mirror of `kernels/csrc/fft.cuh`): its staged real transforms against a
float64 numpy FFT, a round trip, and the spectrogram and the filtered noise
built on them against the JAX Pallas kernels G and B replace, run in
interpret mode as `tests/test_torch_spectrogram.py` and
`tests/test_torch_kernels.py` run them."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu.ops.pallas.noise import pallas_oscillate_noise
from tinyvc_tpu.ops.pallas.spectrogram import pallas_spectrogram
from tinyvc_tpu_torch.kernels import fft, noise
from tinyvc_tpu_torch.kernels import spectrogram as kernel_g

HOP = 480


def test_radices_and_refused_lengths():
    assert fft.fft_radices(960) == (8, 8, 15)
    assert fft.fft_radices(240) == (8, 2, 15)
    assert fft.fft_radices(1024) == (8, 8, 8, 2)
    assert fft.fft_radices(900) == (4, 15, 15)
    for n_fft in (1920, 480, 2048, 1800, 4):
        fft.check_n_fft(n_fft)
        m = n_fft // 2
        assert sorted(fft.bin_positions(m)) == list(range(m))
    # 959 = 7 * 137; 1922 / 2 = 961 = 31^2; odd; above 2048; too short
    for n_fft in (1918, 1922, 1921, 2100, 2):
        with pytest.raises(ValueError):
            fft.check_n_fft(n_fft)


# 1920 = 2 * 8 * 8 * 15 (the path's length); 480 = 2 * 8 * 2 * 15
@pytest.mark.parametrize("n_fft", (1920, 480))
def test_staged_transforms_match_float64(rng, n_fft):
    x = rng.standard_normal((3, n_fft)).astype(np.float32)
    got = fft.rfft_staged(torch.from_numpy(x)).numpy()
    want = np.fft.rfft(x.astype(np.float64))
    # Tolerance 2e-6 of the peak (measured: 1.5e-7): fp32 radix passes
    # whose rounding grows with log2(n), against float64
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())

    spec = (rng.standard_normal((3, n_fft // 2 + 1))
            + 1j * rng.standard_normal((3, n_fft // 2 + 1))).astype(np.complex64)
    got = fft.irfft_staged(torch.from_numpy(spec)).numpy()
    # numpy's irfft ignores the imaginary parts at DC and Nyquist, as the kernel does
    want = np.fft.irfft(spec.astype(np.complex128), n_fft)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_fft", (1920, 480))
def test_staged_round_trip(rng, n_fft):
    x = rng.standard_normal((4, n_fft)).astype(np.float32)
    back = fft.irfft_staged(fft.rfft_staged(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=2e-6 * np.abs(x).max())


def _wave(rng, F):
    t = np.arange(F * HOP) / 24000
    return (0.3 * np.sin(2 * np.pi * rng.uniform(90, 300, (2, 1)) * t)
            + 0.05 * rng.standard_normal((2, F * HOP))).astype(np.float32)


@pytest.mark.parametrize("F", (128, 37))
def test_staged_spectrogram_matches_pallas(rng, F):
    wave = _wave(rng, F)
    got = fft.spectrogram_staged(torch.from_numpy(wave)).numpy()
    assert got.shape == (2, F, 961)
    peak = np.abs(got).max()
    # Tolerance 2e-6 of the peak, as for kernel G's plain version: fp32 FFT
    # passes against the Pallas kernel's fp32 DFT products
    want = np.asarray(pallas_spectrogram(wave, interpret=True, dtype_name="float32"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * peak)
    # and against kernel G's plain version (the DFT matrix of the same table)
    plain = kernel_g.spectrogram(torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=2e-6 * peak)


@pytest.mark.parametrize("B,F", [(2, 37), (1, 64)])
def test_staged_noise_matches_pallas(rng, B, F):
    bins = 961
    mag = np.abs(rng.standard_normal((B, F, bins))).astype(np.float32)
    ang = rng.uniform(-math.pi, math.pi, (B, F, bins)).astype(np.float32)
    tmag = torch.from_numpy(mag)
    # 1e-5: `tests/test_pallas.py`'s bound for the fp32 kernel against the
    # istft (outputs have std ~0.03; this is fp32 summation order)
    want = np.asarray(pallas_oscillate_noise(
        jnp.asarray(mag), 7, angle=jnp.asarray(ang), interpret=True, dtype_name="float32"))
    got = fft.oscillate_noise_staged(tmag, torch.from_numpy(ang)).numpy()
    assert got.shape == (B, F * HOP)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # seed mode: the kernel's hashed phases, equal bit for bit to the TPU's
    want = np.asarray(pallas_oscillate_noise(
        jnp.asarray(mag), 7, interpret=True, dtype_name="float32"))
    got = fft.oscillate_noise_staged(tmag, noise.noise_angles(B, F, bins, 7)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
