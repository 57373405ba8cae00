"""The fused U-Net's pieces in the port (`tinyvc_tpu_torch/kernels/
filter_stage.py`, `kernels/resample.py`, `utils/weights.py`,
`ops/fused_filternet.py`) against the JAX functions they replace, with the
Pallas kernels in interpret mode. On CPU tensors each wrapper takes its plain
version; `chip_smoke.py` holds the CUDA kernels against these on the card.

The chains are compared whole, edges included: the port computes the fused
function (edge-replicated chain input), not the layer-by-layer U-Net's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models.decoder import FilterNet as JFilterNet
from tinyvc_tpu.ops.fused_filternet import filternet_fused_apply as j_fused_apply
from tinyvc_tpu.ops.pallas import filter_stage as jfs
from tinyvc_tpu.ops.pallas.resample import pallas_downsample_t, pallas_upsample_t
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.kernels import filter_stage, resample
from tinyvc_tpu_torch.models.decoder import FilterNet
from tinyvc_tpu_torch.ops.fused_filternet import filternet_fused_apply, fused_weights
from tinyvc_tpu_torch.utils import weights as pweights
from torch_parity import random_params


def _uniform(rng, shape, fan_in):
    b = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-b, b, shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _up_weights(rng, C, Co):
    return (_uniform(rng, (4, C, 3 * C), 3 * C), 0.1 * _uniform(rng, (4, C, 1), 1),
            _uniform(rng, (4 * C, C), C), 0.1 * _uniform(rng, (4 * C, 1), 1),
            _uniform(rng, (Co, C), C), 0.1 * _uniform(rng, (Co, 1), 1))


def _close(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# (fold_k, T, extra xu samples, t_blk): T a multiple of t_blk takes the
# Pallas kernel's streaming scheme, T = 600 its padded scheme
@pytest.mark.parametrize("fold_k,T,extra,t_blk", [
    (0, 512, 0, 256), (0, 600, 10, 256), (7, 512, 0, 256), (7, 600, 10, 256)])
def test_upsample_chain_matches_pallas(rng, fold_k, T, extra, t_blk):
    B, C, Co = 2, 8, 16
    xu = 0.5 * rng.standard_normal((B, C, T + extra)).astype(np.float32)
    cond = 0.5 * rng.standard_normal((B, C, T)).astype(np.float32)
    wconv, bconv, wfilm, bfilm, w5, b5 = _up_weights(rng, C, Co)
    bout = None
    if fold_k:
        w5 = _uniform(rng, (fold_k, C), C)
        b5 = 0.1 * _uniform(rng, (fold_k, 1), 1)
        bout = np.full((1, 1), 0.05, np.float32)
    want = np.asarray(jfs.fused_upsample_chain_t(
        *(jnp.asarray(a) for a in (xu, cond, wconv, bconv, wfilm, bfilm, w5, b5)),
        dtype_name="float32", t_blk=t_blk, interpret=True, fold_k=fold_k,
        bout=None if bout is None else jnp.asarray(bout)))
    got = filter_stage.upsample_chain(*_t(xu, cond, wconv, bconv, wfilm, bfilm, w5, b5),
                                      fold_k=fold_k,
                                      bout=None if bout is None else torch.from_numpy(bout))
    assert got.shape == (B, 1 if fold_k else Co, T)
    # fp32 both sides, sums of <= 3C + C terms in another order through four
    # convs and two FiLM products: 1e-5 of the peak
    _close(got.numpy(), want, 1e-5)
    assert filter_stage.upsample_chain.launches == 0


@pytest.mark.parametrize("T,extra,t_blk", [(512, 0, 256), (300, 7, 256)])
def test_downsample_chain_matches_pallas(rng, T, extra, t_blk):
    B, Cin, Co = 2, 8, 16
    z = 0.5 * rng.standard_normal((B, Cin, T + extra)).astype(np.float32)
    w = (_uniform(rng, (Co, Cin), Cin), 0.1 * _uniform(rng, (Co, 1), 1),
         _uniform(rng, (Cin, 3 * Cin), 3 * Cin), 0.1 * _uniform(rng, (Cin, 1), 1),
         _uniform(rng, (Cin, 3 * Cin), 3 * Cin), 0.1 * _uniform(rng, (Cin, 1), 1),
         _uniform(rng, (Co, 3 * Cin), 3 * Cin), 0.1 * _uniform(rng, (Co, 1), 1))
    want = np.asarray(jfs.fused_downsample_chain_t(
        jnp.asarray(z), *(jnp.asarray(a) for a in w), dtype_name="float32", t_blk=t_blk,
        interpret=True, out_len=T))
    got = filter_stage.downsample_chain(*_t(z, *w), out_len=T)
    assert got.shape == (B, Co, T)
    _close(got.numpy(), want, 1e-5)  # fp32, three convs and a 1x1 in another order
    assert filter_stage.downsample_chain.launches == 0


@pytest.mark.parametrize("T", [512, 300])
def test_conv3_stem_matches_pallas(rng, T):
    """17 true channels, packed with 7 zero rows to 24 as `Decoder.dsp` packs
    them; the port pads the weight columns once (`pack_filter_net`), the
    Pallas wrapper per call (``w_cin``)."""
    B, n, width, Co = 2, 17, 24, 24
    x = np.zeros((B, width, T), np.float32)
    x[:, :n] = rng.standard_normal((B, n, T))
    w = _uniform(rng, (Co, 3 * n), 3 * n)
    b = 0.1 * _uniform(rng, (Co, 1), 1)
    want = np.asarray(jfs.fused_conv3_t(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                        dtype_name="float32", t_blk=256, interpret=True,
                                        w_cin=n))
    w_packed = np.pad(w.reshape(Co, 3, n), ((0, 0), (0, 0), (0, width - n))).reshape(Co, -1)
    got = filter_stage.conv3(*_t(x, w_packed, b))
    _close(got.numpy(), want, 1e-6)  # one conv of 51 terms per output
    assert filter_stage.conv3.launches == 0


@pytest.mark.parametrize("factor", [2, 3, 4, 5])
def test_downsample_linear_matches_pallas(rng, factor):
    R, T = 3, 997
    x = rng.standard_normal((R, T)).astype(np.float32)
    want = np.asarray(pallas_downsample_t(jnp.asarray(x[None]), factor, interpret=True))
    got = resample.downsample_linear(torch.from_numpy(x), factor).numpy()
    assert got.shape == (R, T // factor)
    # a pick, or the mean of two samples: the band matmul rounds once more
    np.testing.assert_allclose(got, want[0, :, :T // factor], atol=1e-6)
    assert resample.downsample_linear.launches == 0


@pytest.mark.parametrize("factor", [2, 3, 4, 5])
def test_upsample_linear_unet_factors_match_pallas(rng, factor):
    R, T = 3, 321
    x = rng.standard_normal((R, T)).astype(np.float32)
    want = np.asarray(pallas_upsample_t(jnp.asarray(x[None]), factor, interpret=True))
    got = resample.upsample_linear(torch.from_numpy(x), factor).numpy()
    assert got.shape == (R, factor * T)
    np.testing.assert_allclose(got, want[0, :, :factor * T], atol=1e-6)  # a two-tap sum


DEC = dict(source_channels=16, filter_channels=(48, 32, 24, 16, 8), content_channels=32)
N_SRC, PACK = 16, 24  # harmonics + noise; the packed stem input


def _nets(rng, F):
    jc, pc = jcfg.DecoderConfig(**DEC), pcfg.DecoderConfig(**DEC)
    L = F * 480
    tree = random_params(JFilterNet(jc), jnp.zeros((1, F, 32)), jnp.full((1, F), 100.0),
                         jnp.zeros((1, L)), jnp.zeros((1, L, N_SRC)))
    net = FilterNet(pc)
    net.load_state_dict(pweights.state_dict_from_jax(tree), strict=True)
    return jc, pc, tree["params"], net.eval()


def test_packed_weights_match_jax(rng):
    _, _, p, net = _nets(rng, 4)
    w = fused_weights(net, PACK)
    eq = np.testing.assert_array_equal
    for i, got in enumerate(w.down):
        for g, want in zip(got, jfs.downsample_params_to_tuple(p[f"down_{i + 1}"])):
            eq(g.numpy(), np.asarray(want))
    n_up = len(w.up)
    for i, got in enumerate(w.up):
        want = list(jfs.upsample_params_to_tuple(p[f"up_{i}"]))
        if i == n_up - 1:  # fused_filternet.py's fold of the output conv
            w_out = jnp.asarray(p["output_layer"]["kernel"])[:, :, 0]
            want = want[:4] + [jnp.dot(w_out, want[4]), jnp.dot(w_out, want[5]),
                               p["output_layer"]["bias"].reshape(1, 1)]
        assert len(got) == len(want)
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-6, atol=1e-7)
    w0, b0 = jfs._conv_weights_t(p["down_0"])
    co = w0.shape[0]
    stem = w.stem[0].numpy().reshape(co, 3, PACK)
    eq(stem[:, :, :N_SRC + 1], np.asarray(w0).reshape(co, 3, N_SRC + 1))
    eq(stem[:, :, N_SRC + 1:], 0.0)
    eq(w.stem[1].numpy(), np.asarray(b0))
    assert fused_weights(net, PACK) is w  # built once, not per call
    with torch.no_grad():
        net.up_0.c1.bias.add_(1.0)
    assert fused_weights(net, PACK) is not w  # rebuilt after an in-place write


def test_filternet_fused_apply_matches_jax(rng):
    F = 24
    L = F * 480
    jc, pc, p, net = _nets(rng, F)
    content = (0.3 * rng.standard_normal((1, F, 32))).astype(np.float32)
    f0 = (np.abs(rng.standard_normal((1, F))) * 200 + 50).astype(np.float32)
    energy = (0.1 * np.abs(rng.standard_normal((1, L)))).astype(np.float32)
    src = np.zeros((1, PACK, L), np.float32)
    src[:, :N_SRC] = 0.3 * rng.standard_normal((1, N_SRC, L))
    src[:, N_SRC] = energy
    want = np.asarray(j_fused_apply(
        p, jc, *(jnp.asarray(a) for a in (content, f0, energy, src)), interpret=True,
        source_channels_first=True, source_prepacked=True, n_prepacked_src=N_SRC))
    with torch.inference_mode():
        got = filternet_fused_apply(net, pc, *_t(content, f0, energy, src)).numpy()
    assert got.shape == (1, L)
    # fp32 through 10 chains and the frame-rate dense layers: 1e-5 of the peak
    _close(got, want, 1e-5)


def test_unet_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions; other placements raise."""
    x = torch.zeros(1, 8, 16)
    w, b = torch.zeros(8, 24), torch.zeros(8, 1)
    with pytest.raises(ValueError):
        resample.downsample_linear(torch.zeros(2, 8, device="meta"), 2)
    with pytest.raises(ValueError):
        filter_stage.conv3(x.to("meta"), w, b)
    with pytest.raises(ValueError):
        filter_stage.downsample_chain(x.to("meta"), *([w] * 8))
    with pytest.raises(ValueError):
        filter_stage.upsample_chain(x, x.to("meta"), *([w] * 6))
    assert filter_stage.conv3.launches == filter_stage.downsample_chain.launches == 0
