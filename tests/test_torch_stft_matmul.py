"""The multi-scale STFT loss's ``impl="matmul"`` form against the JAX
package's on the CPU: `dsp/stft.py::stft_magnitude_matmul` (bf16 frames
times the bf16 windowed-DFT matrix, fp32 sums) and
``multi_scale_stft_loss(impl="matmul")``; ``impl="auto"`` is the rfft."""

import jax
import numpy as np
import pytest
import torch

from tinyvc_tpu.dsp.stft import stft_magnitude_matmul as j_stft_matmul
from tinyvc_tpu.train.losses import multi_scale_stft_loss as j_loss
from tinyvc_tpu_torch.dsp.stft import stft_magnitude_matmul
from tinyvc_tpu_torch.train.losses import multi_scale_stft_loss


def _waves(rng, B=2, L=4800):
    t = np.arange(L) / 24000
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(90, 300, (B, 1)) * t)
    return (x + 0.05 * rng.standard_normal((B, L))).astype(np.float32)


@pytest.mark.parametrize("hop,drop_first", ((16, False), (128, True), (512, False)))
def test_stft_magnitude_matmul_matches_jax(rng, hop, drop_first):
    x = _waves(rng)
    want = np.asarray(jax.jit(lambda a: j_stft_matmul(a, 4 * hop, hop, drop_first))(x))
    got = stft_magnitude_matmul(torch.from_numpy(x), 4 * hop, hop, drop_first)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # the same bf16 operands, exact products, fp32 sums in two orders
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())


def test_matmul_loss_matches_jax_and_auto_is_the_rfft(rng):
    x, y = _waves(rng), _waves(rng)
    want = float(jax.jit(lambda a, b: j_loss(a, b, impl="matmul"))(x, y))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = float(multi_scale_stft_loss(tx, ty, impl="matmul"))
    assert abs(got - want) <= 1e-5 * abs(want)
    rfft = multi_scale_stft_loss(tx, ty, impl="rfft")
    assert torch.equal(multi_scale_stft_loss(tx, ty), rfft)
    # bf16 operands: not the fp32 rfft's loss
    assert abs(float(rfft) - got) > 1e-6 * abs(got)
    with pytest.raises(ValueError, match="impl"):
        multi_scale_stft_loss(tx, ty, impl="fft")


def test_matmul_loss_gradient_flows(rng):
    x = torch.from_numpy(_waves(rng)).requires_grad_(True)
    loss = multi_scale_stft_loss(x, torch.from_numpy(_waves(rng)), impl="matmul")
    (g,) = torch.autograd.grad(loss, x)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0
