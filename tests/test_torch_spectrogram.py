"""Kernel G's plain version (`tinyvc_tpu_torch/kernels/spectrogram.py`)
against `tinyvc_tpu/ops/pallas/spectrogram.py::pallas_spectrogram` in
interpret mode, in its exact ``float32`` mode and its default ``bf16x3``,
and against the rfft spectrograms of both packages; at B=2 with F a multiple
of 128 (one full frame tile) and not (a ragged tile)."""

import numpy as np
import pytest
import torch

from tinyvc_tpu.dsp import spectrogram as jax_spectrogram
from tinyvc_tpu.ops.pallas.spectrogram import pallas_spectrogram
from tinyvc_tpu_torch.dsp.stft import spectrogram as rfft_spectrogram
from tinyvc_tpu_torch.kernels import spectrogram as kernel_g

HOP = 480


def _wave(rng, F):
    t = np.arange(F * HOP) / 24000
    return (0.3 * np.sin(2 * np.pi * rng.uniform(90, 300, (2, 1)) * t)
            + 0.05 * rng.standard_normal((2, F * HOP))).astype(np.float32)


@pytest.mark.parametrize("F", (128, 37))
def test_plain_against_pallas_and_rfft(rng, F):
    wave = _wave(rng, F)
    got = kernel_g.spectrogram(torch.from_numpy(wave)).numpy()
    assert got.shape == (2, F, 961)
    peak = np.abs(got).max()
    # Tolerance 2e-6 of the peak throughout (measured: at most 7.4e-7).
    # fp32 DFT products of 1920 terms on both sides, summed in other orders
    want = np.asarray(pallas_spectrogram(wave, interpret=True, dtype_name="float32"))
    np.testing.assert_allclose(got, want, atol=2e-6 * peak)
    # the TPU default splits both operands into bf16 hi/lo, three products:
    # its docstring's bound is ~1.5e-5 relative, here it is as close as fp32
    want = np.asarray(pallas_spectrogram(wave, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-6 * peak)
    # the exact transform by FFT, in either package: the same function
    np.testing.assert_allclose(got, rfft_spectrogram(torch.from_numpy(wave)).numpy(),
                               atol=2e-6 * peak)
    np.testing.assert_allclose(got, np.asarray(jax_spectrogram(wave)), atol=2e-6 * peak)


def test_dft_matrix_is_the_pallas_one():
    """The table-built matrix equals the float64-built one of
    `_dft_splits` to one fp32 rounding."""
    from tinyvc_tpu.ops.pallas.spectrogram import _dft_splits

    w = kernel_g.dft_matrix(1920, torch.device("cpu")).numpy()
    ref = _dft_splits(1920, 961, 1, 4)[0, :, :HOP].reshape(1920, 2 * 961)
    np.testing.assert_allclose(w, ref, rtol=0, atol=1.2e-7)
