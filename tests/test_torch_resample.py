"""The port's polyphase resampler (`tinyvc_tpu_torch/dsp/resample.py`)
against `tinyvc_tpu.dsp.resample` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu.dsp import resample as jres
from tinyvc_tpu_torch.dsp import resample as pres

RATES = [(44100, 24000), (48000, 24000), (22050, 24000), (16000, 24000), (32000, 24000),
         (24000, 16000)]
# one fp32 conv in two libraries: sums of ~20-150 taps in other orders;
# measured at most 2e-7 of the peak (48 kHz -> 24 kHz), 0 elsewhere
RTOL_OF_PEAK = 1e-6


@pytest.mark.parametrize("orig,new", RATES)
def test_filter_bank_is_jax_bit_for_bit(orig, new):
    want, got = jres._kernel(orig, new), pres._kernel(orig, new)
    assert got[1:] == want[1:]
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("orig,new", RATES)
@pytest.mark.parametrize("shape", [(4801,), (4800,), (2, 4801)], ids=["odd", "even", "batch"])
def test_resample_matches_jax(rng, orig, new, shape):
    x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jres.resample(jnp.asarray(x), orig, new))
    got = pres.resample(torch.from_numpy(x), orig, new)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape == shape[:-1] + (-(-shape[-1] * new // orig),)
    np.testing.assert_allclose(got, want, atol=RTOL_OF_PEAK * np.abs(want).max(), rtol=0)


def test_same_rate_is_the_input():
    x = torch.arange(10.0)
    assert pres.resample(x, 24000, 24000) is x
