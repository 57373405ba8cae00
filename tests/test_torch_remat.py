"""``DecoderConfig.remat`` (`models/decoder.py::FilterNet`): the
layer-by-layer U-Net's Downsample and Upsample calls recomputed in the
backward (``torch.utils.checkpoint``, JAX's ``nn.remat``). Its gradients
against the JAX package's ``remat=True`` U-Net on the CPU at small widths,
and bit for bit the port's own without remat; the forward is unchanged and
a call under ``no_grad`` keeps no checkpoint."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models import Decoder
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.utils.weights import decoder_from_jax, jax_name, to_jax_layout
from torch_parity import numpy_params

DEC = dict(source_channels=16, source_num_layers=1, filter_channels=(32, 24, 16, 12, 8),
           content_channels=32)
B, F = 2, 20
L = F * 480
GRAD_TOL = 1e-5  # each leaf's relative L2, tests/test_torch_train_unet.py's: fp32 sum orders


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as measured: the sums' order follows them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(rng):
    content = rng.standard_normal((B, F, 32)).astype(np.float32)
    f0 = rng.uniform(80, 300, (B, F)).astype(np.float32)
    energy = rng.uniform(0, 0.5, (B, L)).astype(np.float32)
    source = (0.3 * rng.standard_normal((B, L, 16))).astype(np.float32)
    weight = rng.standard_normal((B, L)).astype(np.float32)
    return content, f0, energy, source, weight


def _port_grads(dec_p, remat, content, f0, energy, source, weight):
    dec = decoder_from_jax(dec_p, pcfg.DecoderConfig(**DEC, remat=remat))
    net = dec.filter_net
    args = [torch.from_numpy(x) for x in (content, f0, energy)]
    out = net(*args, torch.from_numpy(source).transpose(1, 2))
    loss = torch.sum(out * torch.from_numpy(weight))
    params = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return out.detach().numpy(), dict(zip(params, grads))


def _leaf(tree, name):
    for part in jax_name(name).split("/"):
        tree = tree[part]
    return np.asarray(tree)


def test_remat_gradients_match_jax_and_the_plain_backward(rng):
    content, f0, energy, source, weight = x = _inputs(rng)
    jc = jcfg.DecoderConfig(**DEC, remat=True)
    D = Decoder(jc, jcfg.AudioConfig())
    dec_p = numpy_params(D, jnp.zeros((1, F, 32)), jnp.full((1, F), 100.0), jnp.zeros((1, L)),
                         jnp.zeros((2,), jnp.uint32), noise_angle=jnp.zeros((1, F, 961)))

    def loss(p):
        out = D.apply(p, content, f0, energy, source,
                      method=lambda m, c, f_, e, s: m.filter_net(c, f_, e, s))
        return jnp.sum(out * weight), out

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(dec_p)
    out, grads = _port_grads(dec_p, True, *x)
    plain_out, plain = _port_grads(dec_p, False, *x)
    np.testing.assert_array_equal(out, plain_out)
    np.testing.assert_allclose(out, np.asarray(jout), atol=1e-5 * np.abs(jout).max())
    jtree = {"params": jg["params"]["filter_net"]}
    worst = 0.0
    for name, g in grads.items():
        np.testing.assert_array_equal(g.numpy(), plain[name].numpy(), err_msg=name)
        want = _leaf(jtree, name)
        err = float(np.linalg.norm(to_jax_layout(g, name) - want) / np.linalg.norm(want))
        worst = max(worst, err)
        assert err <= GRAD_TOL, (name, err)
    print(f"worst gradient leaf {worst:.2e} (relative L2)")


def test_remat_checkpoints_only_under_grad(rng, monkeypatch):
    from tinyvc_tpu_torch.models import decoder as pdecoder

    calls = []
    real = pdecoder.checkpoint
    monkeypatch.setattr(pdecoder, "checkpoint",
                        lambda fn, *a, **k: calls.append(type(fn).__name__) or real(fn, *a, **k))
    content, f0, energy, source, _ = _inputs(rng)
    D = Decoder(jcfg.DecoderConfig(**DEC), jcfg.AudioConfig())
    dec_p = numpy_params(D, jnp.zeros((1, F, 32)), jnp.full((1, F), 100.0), jnp.zeros((1, L)),
                         jnp.zeros((2,), jnp.uint32), noise_angle=jnp.zeros((1, F, 961)))
    cfg = pcfg.DecoderConfig(**DEC, remat=True)
    net = decoder_from_jax(dec_p, cfg).filter_net
    args = [torch.from_numpy(a) for a in (content, f0, energy)]
    src = torch.from_numpy(source).transpose(1, 2)
    with torch.no_grad():
        net(*args, src)
    assert calls == []
    net(*args, src)
    assert calls == ["Downsample"] * 4 + ["Upsample"] * 5
    assert dataclasses.replace(cfg, remat=False) == pcfg.DecoderConfig(**DEC)
