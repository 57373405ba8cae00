"""The training step's losses and its differentiable fused U-Net against the
JAX package on the CPU, fp32, at small widths (`tests/test_training.py`'s
decoder, ``chunk_length`` 9600: every kernel route of the training U-Net
runs: the stem, `downsample_vjp` and the chain kernels at down_1, the chain
kernels at up_3, `upsample_vjp` and the folded chain at up_4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models import Decoder
from tinyvc_tpu.ops.fused_filternet import filternet_fused_apply
from tinyvc_tpu.train.losses import log_mel_loss as j_log_mel_loss
from tinyvc_tpu.train.losses import multi_scale_stft_loss as j_ms_stft_loss
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.kernels import filter_stage as fs
from tinyvc_tpu_torch.kernels import resample
from tinyvc_tpu_torch.ops import fused_filternet
from tinyvc_tpu_torch.ops.fused_filternet import filternet_fused_train
from tinyvc_tpu_torch.train.losses import log_mel_loss, multi_scale_stft_loss
from tinyvc_tpu_torch.utils.weights import decoder_from_jax, state_dict_from_jax
from torch_parity import random_params

DEC = dict(source_channels=16, source_num_layers=1, filter_channels=(32, 24, 16, 12, 8),
           content_channels=32)


def _j_ms(x, y):
    return j_ms_stft_loss(x, y, impl="rfft")


@pytest.mark.parametrize("name", ["ms-stft", "mel"])
def test_losses_match_jax(rng, name):
    """Values and input gradients, with a silent stretch in each signal
    (the gradient-safe magnitude's case)."""
    x = (0.3 * rng.standard_normal((2, 9600))).astype(np.float32)
    y = (0.3 * rng.standard_normal((2, 9600))).astype(np.float32)
    x[0, 1000:4000] = 0.0
    y[1, :2400] = 0.0
    jf, pf = (_j_ms, multi_scale_stft_loss) if name == "ms-stft" else (j_log_mel_loss,
                                                                       log_mel_loss)
    want, gwant = jax.jit(jax.value_and_grad(jf))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    got = pf(xt, torch.from_numpy(y))
    got.backward()
    gerr = float(np.abs(xt.grad.numpy() - np.asarray(gwant)).max() / np.abs(gwant).max())
    print(f"{name}: value {float(got):.6f} vs {float(want):.6f}, gradient {gerr:.1e} of the peak")
    # fp32 FFTs of two libraries: ~1e-7 relative on the value, ~1e-5 of the
    # gradient's peak measured
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert np.isfinite(xt.grad.numpy()).all()
    assert gerr <= 1e-4


def test_ms_stft_gradient_is_chaotic(rng):
    """Why the whole step's gradients are compared under the log-mel loss
    (ROADMAP.md §3): the multi-scale STFT loss's L1 of log magnitudes
    weighs each bin by 1/(|X| + 1e-6), so on a voiced signal the near-empty
    bins between harmonics rule its gradient, and the JAX package's own
    gradient moves by percents when its input moves by 1e-7. The log-mel
    loss sums bins first and moves by ~1e-6."""
    t = np.arange(9600) / 24000
    x = (0.3 * np.sin(2 * np.pi * 150 * t)[None] + 0.01 * rng.standard_normal((2, 9600)))
    x = x.astype(np.float32)
    y = (0.3 * rng.standard_normal((2, 9600))).astype(np.float32)
    xp = x * (1 + 1e-7 * rng.standard_normal(x.shape)).astype(np.float32)
    moved = {}
    for name, f in (("ms-stft", _j_ms), ("mel", j_log_mel_loss)):
        grad = jax.jit(jax.grad(f))
        g0, g1 = np.asarray(grad(x, y)), np.asarray(grad(xp, y))
        moved[name] = float(np.linalg.norm(g1 - g0) / np.linalg.norm(g0))
    print(f"gradient moved under a 1e-7 relative perturbation: {moved}")
    assert moved["ms-stft"] > 1e-3
    assert moved["mel"] < 1e-4


def test_fused_unet_vjp_matches_jax(rng):
    """`filternet_fused_train` against `filternet_fused_apply(differentiable=
    True)` (interpret mode, fp32): the waveform and the vjp for the filter
    net's every parameter and the source, each within 1e-5 of its peak or
    norm (fp32 summation order; ~4e-6 measured)."""
    jc, pc = jcfg.DecoderConfig(**DEC), pcfg.DecoderConfig(**DEC)
    F, L, B = 20, 9600, 2
    dec_p = random_params(Decoder(jc), jnp.zeros((1, F, 32)), jnp.full((1, F), 100.0),
                          jnp.zeros((1, L)), jnp.zeros((2,), jnp.uint32))
    content = rng.standard_normal((B, F, 32)).astype(np.float32)
    f0 = rng.uniform(100, 200, (B, F)).astype(np.float32)
    energy = np.abs(rng.standard_normal((B, L))).astype(np.float32)
    source = rng.standard_normal((B, 16, L)).astype(np.float32)
    g = rng.standard_normal((B, L)).astype(np.float32)

    def jf(p, s):
        return filternet_fused_apply(p, jc, jnp.asarray(content), jnp.asarray(f0),
                                     jnp.asarray(energy), s, interpret=True,
                                     source_channels_first=True, differentiable=True)

    y, vjp = jax.vjp(jax.jit(jf), dec_p["params"]["filter_net"], jnp.asarray(source))
    g_params, g_source = vjp(jnp.asarray(g))

    dec = decoder_from_jax(dec_p, pc)
    src = torch.from_numpy(source).requires_grad_()
    counts = (fs.conv3_grad.launches, resample.resample_grad.launches)
    out = filternet_fused_train(dec.filter_net, pc, torch.from_numpy(content),
                                torch.from_numpy(f0), torch.from_numpy(energy), src, "float32")
    out.backward(torch.from_numpy(g))
    assert (fs.conv3_grad.launches, resample.resample_grad.launches) == counts  # plain on CPU

    y = np.asarray(y)
    assert float(np.abs(out.detach().numpy() - y).max()) <= 1e-5 * np.abs(y).max()
    gs = np.asarray(g_source)
    assert float(np.abs(src.grad.numpy() - gs).max()) <= 1e-5 * np.abs(gs).max()
    want = state_dict_from_jax({"params": g_params})
    errs = {k: float((p.grad - want[k]).norm() / want[k].norm())
            for k, p in dec.filter_net.named_parameters()}
    worst = max(errs, key=errs.get)
    print(f"fused U-Net vjp: worst leaf {worst} {errs[worst]:.1e}")
    assert errs[worst] <= 1e-5


def test_fused_unet_routes_stages_as_jax(monkeypatch, rng):
    """At chunk 9600 the chains of the stem, down_1, up_3 and up_4 (folded)
    and the resamples of down_1 and up_4 run as kernels (plain versions on
    the CPU), the rest as the layer-by-layer modules' bodies."""
    pc = pcfg.DecoderConfig(**DEC)
    dec = decoder_from_jax(random_params(
        Decoder(jcfg.DecoderConfig(**DEC)), jnp.zeros((1, 20, 32)), jnp.full((1, 20), 100.0),
        jnp.zeros((1, 9600)), jnp.zeros((2,), jnp.uint32)), pc)
    seen = []
    for name, label in (("stem_conv_vjp", "Stem"), ("down_chain_vjp", "DownChain"),
                        ("up_chain_vjp", "UpChain")):
        orig = getattr(fused_filternet, name)

        def spy(*a, _orig=orig, _name=label):
            seen.append((_name, a[0].shape[-1]))
            return _orig(*a)

        monkeypatch.setattr(fused_filternet, name, spy)
    for name in ("UpsampleVJP", "DownsampleVJP"):
        cls = getattr(resample, name)
        orig = cls.apply

        def spy(x, f, _orig=orig, _name=name):
            seen.append((_name, x.shape[-1]))
            return _orig(x, f)

        monkeypatch.setattr(cls, "apply", spy)
    filternet_fused_train(dec.filter_net, pc, torch.zeros(1, 20, 32), torch.full((1, 20), 120.0),
                          torch.rand(1, 9600), torch.rand(1, 16, 9600) - 0.5)
    assert seen == [("Stem", 9600), ("DownsampleVJP", 9600), ("DownChain", 1920),
                    ("UpChain", 1920), ("UpsampleVJP", 1920), ("UpChain", 9600)]
