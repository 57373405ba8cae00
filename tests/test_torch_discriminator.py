"""The port's discriminator (`tinyvc_tpu_torch/models/discriminator.py`)
and GAN losses against the JAX package's on the CPU: one JAX parameter tree
carried across with `utils/weights.py::discriminator_from_jax`, the same
numpy inputs, every logit and feature map compared; the fused MRD against
the conv form with the valid-count losses; the init distributions."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models.discriminator import Discriminator as JaxDiscriminator
from tinyvc_tpu.models.discriminator import fused_mrd_valid_counts as j_valid_counts
from tinyvc_tpu.train import losses as jl
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.models.discriminator import Discriminator, fused_mrd_valid_counts
from tinyvc_tpu_torch.train import decoder_train as pdt
from tinyvc_tpu_torch.train import losses as pl
from tinyvc_tpu_torch.utils.weights import discriminator_from_jax
from torch_parity import random_params

T = 8000
SMALL = dict(periods=(2, 3), resolutions=(32,), channels=4, max_channels=16, num_layers=2)


@pytest.fixture(autouse=True)
def _two_threads():
    """At most two intra-op threads per test: the tier-1 run puts six workers
    on the CPU's cores, where more threads per worker only spin against each
    other's (a full-width discriminator test took 300x its single-process
    time so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _wave(rng, B=2, length=T):
    return (0.3 * rng.standard_normal((B, length))).astype(np.float32)


def _jax_apply(cfg, params, x):
    return jax.jit(JaxDiscriminator(cfg).apply)(params, jnp.asarray(x))


def _rel_peak(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("fixed", [False, True], ids=["faithful", "fixed_activation"])
@pytest.mark.parametrize("widths", ["full", "small"])
def test_discriminator_matches_jax(rng, widths, fixed):
    """Every logit and feature map within 1e-5 of its peak, B=2, T=8000:
    the MPD (reflect pad at periods 3, 7, 11) and the MRD's conv form."""
    kw = {} if widths == "full" else SMALL
    jc = jcfg.DiscriminatorConfig(mrd_fixed_activation=fixed, **kw)
    pc = pcfg.DiscriminatorConfig(mrd_fixed_activation=fixed, **kw)
    x = _wave(rng)
    params = random_params(JaxDiscriminator(jc), jnp.zeros((1, T)))
    want_l, want_f = _jax_apply(jc, params, x)
    disc = discriminator_from_jax(params, pc)
    with torch.no_grad():
        got_l, got_f = disc(torch.from_numpy(x))
    assert len(got_l) == len(want_l) and len(got_f) == len(want_f)
    errs = [_rel_peak(g.numpy(), w) for g, w in zip(got_l + got_f, list(want_l) + list(want_f))]
    assert all(g.shape == w.shape for g, w in zip(got_f, want_f))
    print(f"{widths} {'fixed' if fixed else 'faithful'}: {len(errs)} maps, worst error "
          f"{max(errs):.2e} of the peak")
    assert max(errs) <= 1e-5


@pytest.mark.parametrize("impl", ["hybrid", "nhwc", "unfold", "xres"])
def test_layout_lowerings_are_the_conv_form(rng, impl):
    """JAX's TPU layout lowerings of the MRD run as the conv form in the
    port: identical outputs to "lax"."""
    x = torch.from_numpy(_wave(rng, length=2400))
    lax = Discriminator(pcfg.DiscriminatorConfig(**SMALL))
    pdt.init_params(lax, torch.Generator().manual_seed(0))
    alias = Discriminator(pcfg.DiscriminatorConfig(mrd_conv_impl=impl, **SMALL))
    alias.load_state_dict(lax.state_dict())
    with torch.no_grad():
        a, b = lax(x), alias(x)
    for u, v in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(u, v)


def test_fused_losses_match_the_conv_form(rng):
    """The fused MRD's plane-major outputs under the valid-count losses
    against the conv form's dense losses (rtol 1e-4, as
    `tests/test_mrd_fused.py:177-206`), full widths, T=8000, fp32."""
    lax_cfg = pcfg.DiscriminatorConfig()
    fus_cfg = dataclasses.replace(lax_cfg, mrd_conv_impl="fused")
    lax = Discriminator(lax_cfg)
    pdt.init_params(lax, torch.Generator().manual_seed(0))
    fus = Discriminator(fus_cfg)
    fus.load_state_dict(lax.state_dict())
    x, y = torch.from_numpy(_wave(rng)), torch.from_numpy(_wave(rng))
    with torch.no_grad():
        lr, fr = lax(x)
        lf, ff = lax(y)
        frl, frf = fus(x)
        ffl, fff = fus(y)
    lc, fc = fused_mrd_valid_counts(fus_cfg, T)
    pairs = [
        (pl.generator_adversarial_loss(ffl, lc), pl.generator_adversarial_loss(lf)),
        (pl.discriminator_adversarial_loss(frl, ffl, lc),
         pl.discriminator_adversarial_loss(lr, lf)),
        (pl.feature_matching_loss(frf, fff, fc), pl.feature_matching_loss(fr, ff)),
    ]
    for got, want in pairs:
        print(f"fused {float(got):.6f} vs conv form {float(want):.6f}")
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_losses_match_jax(rng):
    """The LSGAN and feature-matching losses, dense and with valid counts,
    against `tinyvc_tpu/train/losses.py` on the same arrays."""
    dense = [rng.standard_normal((2, 1, 7, 5)).astype(np.float32) for _ in range(2)]
    flat = rng.standard_normal((2, 3, 40)).astype(np.float32)
    flat[:, :, 25:] = 0.0
    a = dense + [flat]
    b = [x + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in a]
    b[-1][:, :, 25:] = 0.0
    counts = [None, None, 25]
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    for cnt in (None, counts):
        pairs = [
            (pl.generator_adversarial_loss(t(a), cnt), jl.generator_adversarial_loss(j(a), cnt)),
            (pl.discriminator_adversarial_loss(t(a), t(b), cnt),
             jl.discriminator_adversarial_loss(j(a), j(b), cnt)),
            (pl.feature_matching_loss(t(a), t(b), cnt), jl.feature_matching_loss(j(a), j(b), cnt)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("length", [2400, T])
def test_valid_counts_match_jax(length):
    for kw in ({}, SMALL):
        want = j_valid_counts(jcfg.DiscriminatorConfig(**kw), length)
        assert fused_mrd_valid_counts(pcfg.DiscriminatorConfig(**kw), length) == want


def test_fused_refuses_the_fixed_activation():
    disc = Discriminator(pcfg.DiscriminatorConfig(mrd_conv_impl="fused",
                                                  mrd_fixed_activation=True, **SMALL))
    with pytest.raises(ValueError, match="faithful"):
        disc(torch.zeros((1, 2400)))


def test_init_draws_flax_distributions():
    """`init_params` on the discriminator: ``v`` U(+-1/sqrt(kh*kw*cin)),
    ``g`` the norm of ``v`` per output channel (so the effective weight is
    ``v``), the bias U(+-1/sqrt(kh*kw*cin)); the same draws from the same
    seed; the parameter names and shapes of JAX's tree."""
    cfg = pcfg.DiscriminatorConfig()
    disc = Discriminator(cfg)
    pdt.init_params(disc, torch.Generator().manual_seed(0))
    conv = disc.mrd_64.conv_2
    kh, kw, cin, _ = conv.v.shape
    bound = 1.0 / math.sqrt(kh * kw * cin)
    v = conv.v.detach()
    assert float(v.abs().max()) <= bound and float(v.abs().max()) > 0.99 * bound
    assert abs(float(v.std()) - bound / math.sqrt(3.0)) < 0.02 * bound
    assert float(conv.bias.detach().abs().max()) <= bound
    norm = torch.linalg.vector_norm(v, dim=(0, 1, 2))
    torch.testing.assert_close(conv.g.detach(), norm, rtol=1e-6, atol=0)
    torch.testing.assert_close(conv.effective_weight().detach(), v, rtol=1e-5, atol=1e-7)
    again = Discriminator(cfg)
    pdt.init_params(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(disc.parameters(), again.parameters()))
    shapes = jax.eval_shape(JaxDiscriminator(jcfg.DiscriminatorConfig()).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, T)))
    want = {".".join(getattr(k, "key", "") for k in path[1:]): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {n: tuple(p.shape) for n, p in disc.named_parameters()} == want


def test_reference_state_dict_imports_as_jax_does(rng):
    """A state dict in the reference's weight-norm layout (``parametrizations.
    weight.original0`` g ``[out, 1, 1, 1]``, ``original1`` v ``[out, in, kh,
    kw]``) built from a random tree: the port's `torch_compat_disc` and JAX's
    ``discriminator_params_from_torch`` carried over by
    ``discriminator_from_jax`` give the same parameters and equal outputs."""
    from tinyvc_tpu.utils.torch_compat_disc import discriminator_params_from_torch
    from tinyvc_tpu_torch.utils.torch_compat_disc import discriminator_from_torch

    jc, pc = jcfg.DiscriminatorConfig(**SMALL), pcfg.DiscriminatorConfig(**SMALL)
    tree = random_params(JaxDiscriminator(jc), jnp.zeros((1, T)))["params"]
    sd = {}
    for kind, names, key in (("MPD", jc.periods, "mpd"), ("MRD", jc.resolutions, "mrd")):
        for i, name in enumerate(names):
            for conv, leaf in tree[f"{key}_{name}"].items():
                prefix = f"{kind}.sub_discs.{i}." + ("post" if conv == "post" else
                                                     f"convs.{conv.split('_')[1]}")
                sd[f"{prefix}.parametrizations.weight.original0"] = torch.from_numpy(
                    np.array(leaf["g"]).reshape(-1, 1, 1, 1))
                sd[f"{prefix}.parametrizations.weight.original1"] = torch.from_numpy(
                    np.transpose(np.asarray(leaf["v"]), (3, 2, 0, 1)).copy())
                sd[f"{prefix}.bias"] = torch.from_numpy(np.array(leaf["bias"]))
    port = discriminator_from_torch(sd, pc)
    via_jax = discriminator_from_jax(
        discriminator_params_from_torch(sd, jc.periods, jc.resolutions, jc.num_layers), pc)
    for (n, p), q in zip(port.named_parameters(), via_jax.parameters()):
        assert torch.equal(p, q), n
    x = torch.from_numpy(_wave(rng))
    with torch.no_grad():
        (la, fa), (lb, fb) = port(x), via_jax(x)
    assert all(torch.equal(a, b) for a, b in zip(la + fa, lb + fb))
    assert torch.equal(port(x)[0][0], discriminator_from_jax({"params": tree}, pc)(x)[0][0])
