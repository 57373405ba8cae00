"""The training step's gradient kernels of the port (I, J, K, L in
`tinyvc_tpu_torch/kernels/`) against the JAX package's backward functions,
run in interpret mode on the CPU in fp32, as `tests/test_filter_stage.py`
and `tests/test_resample.py` run them. On CPU tensors each wrapper takes its
plain version; `chip_smoke.py` holds the CUDA kernels to these plain
versions on the card. Each comparison prints its measured error."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu.ops.pallas import filter_stage as jfs
from tinyvc_tpu.ops.pallas.oscillator import _pallas_backward_amps, _xla_fallback
from tinyvc_tpu.ops.pallas.resample import downsample_vjp as j_downsample_vjp
from tinyvc_tpu.ops.pallas.resample import upsample_vjp as j_upsample_vjp
from tinyvc_tpu_torch.kernels import build
from tinyvc_tpu_torch.kernels import filter_stage as fs
from tinyvc_tpu_torch.kernels import oscillator, resample

# fp32 sums in another order than the JAX backward kernels': ~1e-6 of each
# output's peak measured; 1e-4 of the peak is the bound
PEAK_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_peak(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _r(rng, *shape, scale=0.5):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _osc_amps_grad_truth(f0, g, frame=480, sr=24000, fmin=20.0):
    """float64 vjp of ``oscillate_harmonics(f0) * interp(amps)`` in amps."""
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
    k = np.arange(1, g.shape[1] + 1)
    m = np.transpose(g, (0, 2, 1)) * np.sin(2 * np.pi * np.mod(phase[:, :, None] * k, 1.0))
    m = m * uv[:, :, None]
    out = np.zeros((B, F, g.shape[1]))
    for b in range(B):
        np.add.at(out[b], j, m[b] * (1 - fr)[:, None])
        np.add.at(out[b], j1, m[b] * fr[:, None])
    return out


@pytest.mark.parametrize("H1", [15, 21])
def test_oscillator_amps_grad_closed_form_matches_truth_and_jax(rng, H1):
    """Kernel I's arithmetic in its own order (`oscillator_amps_grad_closed_form`:
    kernel A's closed-form phase, its lanes' fused multiply-adds, its warps'
    reduce-scatter order, the shift-add) within 1e-5 of the float64 vjp's
    peak; within PEAK_RTOL of the JAX package's exact vjp of the same
    oscillator (`_xla_fallback`), and nearer the float64 vjp than the Pallas
    backward kernel it replaces in interpret mode. 21 harmonics: rounds of 8
    past the second."""
    B, F = 2, 20
    f0 = (150.0 + 20.0 * rng.standard_normal((B, F))).astype(np.float32)
    f0[1, 3:6] = 0.0  # an unvoiced run
    g = _r(rng, B, H1, F * 480, scale=1.0)
    got = oscillator.oscillator_amps_grad_closed_form(_t(f0), _t(g)).numpy()
    truth = _osc_amps_grad_truth(f0, g)
    amps = np.ones((B, F, H1), np.float32)
    _, vjp = jax.vjp(lambda a: _xla_fallback(jnp.asarray(f0), a, 480, 24000, 20.0),
                     jnp.asarray(amps))
    (want_xla,) = vjp(jnp.asarray(np.transpose(g, (0, 2, 1))))
    want_pallas = jax.jit(lambda f, gg: _pallas_backward_amps(f, gg, 480, 24000, 20.0, 24, True))(
        f0, g)
    err_truth = _rel_peak(got, truth)
    err_xla = _rel_peak(got, want_xla)
    err_pallas_truth = _rel_peak(want_pallas, truth)
    print(f"I closed form: from the float64 vjp {err_truth:.2e}, vs XLA vjp {err_xla:.2e}; "
          f"Pallas from the float64 vjp {err_pallas_truth:.2e}")
    assert got.shape == (B, F, H1) and got.dtype == np.float32
    assert err_truth <= 1e-5
    assert err_xla <= PEAK_RTOL
    assert err_truth <= err_pallas_truth


def test_oscillator_amps_grad_closed_form_layout_is_the_kernels():
    """The mirror's lane order and the wrapper's harmonic limit are kernel
    I's (`csrc/oscillator.cu`): rounds of 8 harmonics, whose 16 sums a lane
    reduce-scatter across lane bits 8, 4, 2, 1 and then 16, up to four
    rounds; one unit a lane, in 64 x ceil(units / 32) threads a frame."""
    src = (build.CSRC / "oscillator.cu").read_text()
    assert re.search(r"constexpr int kRound = 8;", src)
    rounds = int(re.search(r"constexpr int kMaxH1 = (\d+) \* kRound", src).group(1))
    assert oscillator.MAX_GRAD_HARMONICS == rounds * 8
    assert re.findall(r"reduce_scatter_step<(\d+)>\(acc, lane\)", src) == ["8", "4", "2", "1"]
    assert "acc[0] += __shfl_xor_sync(kFull, acc[0], 16);" in src
    assert "64 * (((frame - frame / 2 + vec - 1) / vec + 31) / 32)" in src
    x = torch.arange(32, dtype=torch.float32) * 2.0 ** -20 + 1.0  # sums that round
    want = x.view(2, 2, 2, 2, 2)
    for dim in (1, 1, 1, 1, 0):  # bits 8, 4, 2, 1, then 16
        want = want.select(dim, 0) + want.select(dim, 1)
    assert torch.equal(oscillator._lane_tree_sum(x), want)


def test_oscillator_amps_grad_takes_16_byte_aligned_g(monkeypatch):
    """Kernel I reads g in 16-byte loads: its wrapper raises for a g that
    does not start on a 16-byte boundary, and `OscillatorBank`'s backward
    hands it an aligned copy of such a cotangent."""
    launched = []
    monkeypatch.setattr(oscillator.oscillator_amps_grad, "launches", 0)
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(build, "launch", lambda kernel, t, *args: launched.append(args[1]))
    f0 = torch.full((1, 4), 100.0)
    g = torch.arange(15 * 4 * 480 + 1, dtype=torch.float32)[1:].view(1, 15, 4 * 480)
    assert g.data_ptr() % 16 != 0 and g.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        oscillator.oscillator_amps_grad(f0, g)
    with pytest.raises(ValueError, match="at most 32"):
        oscillator.oscillator_amps_grad(f0, torch.zeros(1, 33, 4 * 480))
    ctx = type("Ctx", (), {"saved_tensors": (f0,), "args": (480, 24000, 20.0)})()
    oscillator.OscillatorBank.backward(ctx, g)
    assert len(launched) == 1 and launched[0].data_ptr() % 16 == 0
    assert torch.equal(launched[0], g)


@pytest.mark.parametrize("H1", [15, 21])
def test_oscillator_amps_grad_matches_jax(rng, H1):
    """Kernel I's plain version against the JAX package's exact vjp of the
    same oscillator (the XLA chain `_xla_fallback`, the phase scheme the
    plain version ports), and against the Pallas backward kernel it
    replaces, whose phase is integrated by another scheme (ROADMAP.md §3:
    in interpret mode it departs further from the float64 vjp than the
    port does). 21 harmonics: past the 16 of kernel I's first round."""
    B, F = 2, 20
    f0 = (150.0 + 20.0 * rng.standard_normal((B, F))).astype(np.float32)
    f0[1, 3:6] = 0.0  # an unvoiced run
    g = _r(rng, B, H1, F * 480, scale=1.0)
    got = oscillator.oscillator_amps_grad(_t(f0), _t(g)).numpy()

    amps = np.ones((B, F, H1), np.float32)
    _, vjp = jax.vjp(lambda a: _xla_fallback(jnp.asarray(f0), a, 480, 24000, 20.0),
                     jnp.asarray(amps))
    (want_xla,) = vjp(jnp.asarray(np.transpose(g, (0, 2, 1))))
    err_xla = _rel_peak(got, want_xla)
    want_pallas = jax.jit(lambda f, gg: _pallas_backward_amps(f, gg, 480, 24000, 20.0, 24, True))(
        f0, g)
    truth = _osc_amps_grad_truth(f0, g)
    err_port_truth = _rel_peak(got, truth)
    err_pallas_truth = _rel_peak(want_pallas, truth)
    print(f"I: vs XLA vjp {err_xla:.2e}, vs Pallas {_rel_peak(got, want_pallas):.2e}; "
          f"from the float64 vjp: port {err_port_truth:.2e}, Pallas {err_pallas_truth:.2e}")
    assert got.shape == (B, F, H1)
    assert err_xla <= PEAK_RTOL
    assert err_port_truth <= err_pallas_truth
    assert oscillator.oscillator_amps_grad.launches == 0


def test_oscillator_bank_function_grads_amps_only(rng):
    f0 = torch.full((1, 6), 140.0)
    amps = torch.rand(1, 6, 15, requires_grad=True)
    f0.requires_grad_()
    y = oscillator.OscillatorBank.apply(f0, amps, 480, 24000, 20.0)
    g = torch.from_numpy(_r(rng, 1, 15, 6 * 480))
    y.backward(g)
    assert f0.grad is None
    want = oscillator.oscillator_amps_grad_plain(f0.detach(), g)
    np.testing.assert_allclose(amps.grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("f,T", [(4, 2400), (5, 1920), (3, 37)])
def test_upsample_grad_matches_jax(rng, f, T):
    """J's up mode: the vjp of `upsample_vjp` (band transpose and edge
    corrections, interpret mode)."""
    x = _r(rng, 2, 3, T)
    g = _r(rng, 2, 3, T * f, scale=1.0)
    _, vjp = jax.vjp(lambda a: j_upsample_vjp(a, f, 128 * f * 4, True, T * f), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = resample.resample_grad(_t(g.reshape(6, -1)), T, f, True).numpy().reshape(2, 3, T)
    err = _rel_peak(got, want)
    print(f"J up f={f} T={T}: {err:.2e}")
    assert err <= PEAK_RTOL
    assert resample.resample_grad.launches == 0


@pytest.mark.parametrize("f,T", [(4, 9600), (5, 9600), (3, 1000)])
def test_downsample_grad_matches_jax(rng, f, T):
    """J's down mode, with an input longer than a whole number of blocks
    where T allows."""
    x = _r(rng, 2, 3, T)
    n = T // f
    g = _r(rng, 2, 3, n, scale=1.0)
    _, vjp = jax.vjp(lambda a: j_downsample_vjp(a, f, 2560, True, n), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = resample.resample_grad(_t(g.reshape(6, -1)), T, f, False).numpy().reshape(2, 3, T)
    err = _rel_peak(got, want)
    print(f"J down f={f} T={T}: {err:.2e}")
    assert err <= PEAK_RTOL


def test_resample_functions_are_c_d_forward_j_backward(rng):
    x = torch.from_numpy(_r(rng, 2, 3, 50)).requires_grad_()
    y = resample.upsample_vjp(x, 4)
    g = torch.from_numpy(_r(rng, 2, 3, 200))
    y.backward(g)
    want = resample.upsample_linear_grad_plain(g.reshape(6, -1), 50, 4).reshape(2, 3, 50)
    np.testing.assert_array_equal(x.grad.numpy(), want.numpy())
    x.grad = None
    y = resample.downsample_vjp(x, 5)
    y.backward(torch.ones_like(y))
    assert y.shape == (2, 3, 10)
    np.testing.assert_array_equal(x.grad.sum(-1).numpy(), np.full((2, 3), 10.0))


def _up_weights(rng, C, co, fold):
    return [_r(rng, 4, C, 3 * C, scale=0.3), _r(rng, 4, C, 1, scale=0.1),
            _r(rng, 4 * C, C, scale=0.3), _r(rng, 4 * C, 1, scale=0.1),
            _r(rng, fold or co, C, scale=0.3), _r(rng, fold or co, 1, scale=0.1)]


@pytest.mark.parametrize("fold", [0, 7])
def test_up_chain_grad_matches_jax(rng, fold):
    """K against `fused_upsample_chain_t_bwd` (tiles of 512 over 1920
    samples, so the spill bands and the padded tail are exercised), every
    output: input, cond, all weights and biases, and gbout."""
    B, C, T = 2, 12, 1920
    co = 1 if fold else 8
    xu, cond = _r(rng, B, C, T), _r(rng, B, C, T)
    ws = _up_weights(rng, C, co, fold)
    bout = _r(rng, 1, 1, scale=0.1)
    gy = _r(rng, B, co, T, scale=1.0)
    want = jax.jit(lambda *a: jfs.fused_upsample_chain_t_bwd(
        *a, dtype_name="float32", t_blk=512, interpret=True, fold_k=fold))(xu, cond, *ws, gy)
    got = fs.upsample_chain_grad(_t(xu), _t(cond), *map(_t, ws), _t(gy), fold,
                                 _t(bout) if fold else None)
    names = "gx gc gwconv gbconv gwfilm gbfilm gw5 gb5".split()
    errs = {n: _rel_peak(g.numpy(), w) for n, g, w in zip(names, got, want)}
    print(f"K fold={fold}: " + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()))
    assert max(errs.values()) <= PEAK_RTOL, errs
    if fold:
        np.testing.assert_allclose(got[8].numpy(), np.asarray(want[8]), rtol=1e-5)
    else:
        assert float(got[8].abs().max()) == 0.0 == float(np.abs(want[8]).max())
    assert fs.upsample_chain_grad.launches == 0


def test_down_chain_grad_matches_jax(rng):
    """L against `fused_downsample_chain_t_bwd`, every output."""
    B, cin, co, T = 2, 12, 16, 1920
    z = _r(rng, B, cin, T)
    ws = [_r(rng, co, cin, scale=0.3), _r(rng, co, 1, scale=0.1),
          _r(rng, cin, 3 * cin, scale=0.3), _r(rng, cin, 1, scale=0.1),
          _r(rng, cin, 3 * cin, scale=0.3), _r(rng, cin, 1, scale=0.1),
          _r(rng, co, 3 * cin, scale=0.3), _r(rng, co, 1, scale=0.1)]
    gy = _r(rng, B, co, T, scale=1.0)
    want = jax.jit(lambda *a: jfs.fused_downsample_chain_t_bwd(
        *a, dtype_name="float32", t_blk=512, interpret=True))(z, *ws, gy)
    got = fs.downsample_chain_grad(_t(z), *map(_t, ws), _t(gy))
    errs = [_rel_peak(g.numpy(), w) for g, w in zip(got, want)]
    print("L down: " + ", ".join(f"{e:.1e}" for e in errs))
    assert max(errs) <= PEAK_RTOL


def test_stem_grad_matches_jax(rng):
    """L in stem mode against `fused_conv3_t_bwd` with the stem's 17 true
    input channels packed into 24: the zero rows get no gradient, and the
    weight gradient of the zero columns is the packing's to drop."""
    B, T, co = 2, 1920, 8
    x = _r(rng, B, 24, T)
    x[:, 17:] = 0.0
    w = _r(rng, co, 3 * 17, scale=0.3)
    b = _r(rng, co, 1, scale=0.1)
    gy = _r(rng, B, co, T, scale=1.0)
    want = jax.jit(lambda *a: jfs.fused_conv3_t_bwd(
        *a, dtype_name="float32", t_blk=512, interpret=True, w_cin=17))(x, w, b, gy)
    wp = np.concatenate([w.reshape(co, 3, 17), np.zeros((co, 3, 7), np.float32)], 2)
    gx, gw, gb = fs.conv3_grad(_t(x), _t(wp.reshape(co, 72)), _t(b), _t(gy))
    gw = gw.numpy().reshape(co, 3, 24)
    errs = [_rel_peak(gx.numpy(), want[0]), _rel_peak(gw[:, :, :17].reshape(co, 51), want[1]),
            _rel_peak(gb.numpy(), want[2])]
    print("L stem: " + ", ".join(f"{e:.1e}" for e in errs))
    assert max(errs) <= PEAK_RTOL
    assert float(gx[:, 17:].abs().max()) == 0.0


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("fold", [0, 7])
def test_up_chain_grad_bf16_rounds_where_jax_does(rng, fold):
    """K's plain version with bf16 operands against the JAX backward kernel
    with ``dtype_name="bfloat16"``: the same rounding places, so the two
    differ where a rounding lands one bf16 step apart (~1e-3 of the norm),
    against ~0.1 for the fp32 plain version."""
    B, C, T = 2, 12, 1920
    co = 1 if fold else 8
    xu, cond = _bf16(_r(rng, B, C, T)), _bf16(_r(rng, B, C, T))
    ws = _up_weights(rng, C, co, fold)
    bout = _r(rng, 1, 1, scale=0.1)
    gy = _r(rng, B, co, T, scale=1.0)
    want = jax.jit(lambda *a: jfs.fused_upsample_chain_t_bwd(
        *a, dtype_name="bfloat16", t_blk=512, interpret=True, fold_k=fold))(xu, cond, *ws, gy)
    args = (*map(_t, ws), _t(gy), fold, _t(bout) if fold else None)
    got = fs.upsample_chain_grad(_t(xu).bfloat16(), _t(cond).bfloat16(), *args)
    fp32 = fs.upsample_chain_grad(_t(xu), _t(cond), *args)
    errs = [_rel_l2(g.numpy(), w) for g, w in zip(got[:8], want)]
    errs32 = [_rel_l2(g.numpy(), w) for g, w in zip(fp32[:8], want)]
    print(f"K bf16 fold={fold}: relative L2 " + ", ".join(f"{e:.1e}" for e in errs)
          + "; fp32 plain " + ", ".join(f"{e:.1e}" for e in errs32))
    assert max(errs) <= 2.0**-7
    assert max(errs32) > 2.0**-7  # the check can tell bf16 from fp32


def test_down_chain_grad_bf16_rounds_where_jax_does(rng):
    B, cin, co, T = 2, 12, 16, 1920
    z = _bf16(_r(rng, B, cin, T))
    ws = [_r(rng, co, cin, scale=0.3), _r(rng, co, 1, scale=0.1),
          _r(rng, cin, 3 * cin, scale=0.3), _r(rng, cin, 1, scale=0.1),
          _r(rng, cin, 3 * cin, scale=0.3), _r(rng, cin, 1, scale=0.1),
          _r(rng, co, 3 * cin, scale=0.3), _r(rng, co, 1, scale=0.1)]
    gy = _r(rng, B, co, T, scale=1.0)
    want = jax.jit(lambda *a: jfs.fused_downsample_chain_t_bwd(
        *a, dtype_name="bfloat16", t_blk=512, interpret=True))(z, *ws, gy)
    got = fs.downsample_chain_grad(_t(z).bfloat16(), *map(_t, ws), _t(gy))
    errs = [_rel_l2(g.numpy(), w) for g, w in zip(got, want)]
    print("L bf16: relative L2 " + ", ".join(f"{e:.1e}" for e in errs))
    assert max(errs) <= 2.0**-7


def test_plain_grads_are_autograd_of_the_plain_forwards_in_fp32(rng):
    """In fp32 the plain versions of K and L are exactly autograd through
    the plain forwards (no rounding placed)."""
    B, C, T = 1, 8, 300
    xu = torch.from_numpy(_r(rng, B, C, T)).requires_grad_()
    cond = torch.from_numpy(_r(rng, B, C, T)).requires_grad_()
    ws = [torch.from_numpy(w).requires_grad_() for w in _up_weights(rng, C, 4, 0)]
    gy = torch.from_numpy(_r(rng, B, 4, T))
    fs.upsample_chain_plain(xu, cond, *ws).backward(gy)
    got = fs.upsample_chain_grad(xu.detach(), cond.detach(), *[w.detach() for w in ws], gy)
    for a, b in zip(got, [xu.grad, cond.grad] + [w.grad for w in ws]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def _chain_case(rng, kind, bf16):
    """(forward, plain grad, input pre-activation buffer) of a small up,
    folded up or down chain on CPU tensors (bf16 operands with ``bf16``)."""
    dt = torch.bfloat16 if bf16 else torch.float32
    B, C, T = 2, 8, 300
    if kind == "down":
        co = 12
        z = torch.from_numpy(_r(rng, B, C, T)).to(dt)
        ws = [_t(w) for w in (_r(rng, co, C, scale=0.3), _r(rng, co, 1, scale=0.1),
                              _r(rng, C, 3 * C, scale=0.3), _r(rng, C, 1, scale=0.1),
                              _r(rng, C, 3 * C, scale=0.3), _r(rng, C, 1, scale=0.1),
                              _r(rng, co, 3 * C, scale=0.3), _r(rng, co, 1, scale=0.1))]
        gy = _t(_r(rng, B, co, T))
        return (lambda pre: fs.downsample_chain(z, *ws, pre=pre),
                lambda pre: fs.downsample_chain_grad_plain(z, *ws, gy, pre),
                fs.chain_pre(z, T))
    fold = 7 if kind == "fold" else 0
    co = 1 if fold else 4
    xu, cond = (torch.from_numpy(_r(rng, B, C, T)).to(dt) for _ in range(2))
    ws = [_t(w) for w in _up_weights(rng, C, co, fold)]
    bout = _t(_r(rng, 1, 1, scale=0.1)) if fold else None
    gy = _t(_r(rng, B, co, T))
    return (lambda pre: fs.upsample_chain(xu, cond, *ws, fold, bout, pre=pre),
            lambda pre: fs.upsample_chain_grad_plain(xu, cond, *ws, gy, fold, bout, pre),
            fs.chain_pre(cond, T, fold))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["up", "fold", "down"])
def test_chain_grads_take_the_forwards_branches(monkeypatch, rng, kind, bf16):
    """Given the forward's inner pre-activations (``pre``), the plain
    versions of K and L take each leaky ReLU's branch from their signs:
    with the forward's own, the gradients are those of the recomputed
    chain; with every one positive (negative), those of the chain whose
    inner leaky ReLUs have the slope 1 (0.1) in the backward and the same
    values in the forward (each output within 1e-5 of its peak, fp32 sums
    in another order; bf16 operands 2**-7, a cotangent rounded to bf16 one
    step apart). The input's leaky ReLU keeps its own branch."""
    forward, grad, pre = _chain_case(rng, kind, bf16)
    tol = 2.0**-7 if bf16 else 1e-5

    def close(got, want):
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())

    pre.fill_(float("nan"))
    forward(pre)
    own = grad(None)
    close(grad(pre), own)  # the same branches, autograd's sums in another order
    for sign, slope in ((1.0, 1.0), (-1.0, 0.1)):
        got = grad(torch.full_like(pre, sign))
        with monkeypatch.context() as m:
            m.setattr(fs, "_act", lambda h, *_, s=slope: h * s + (fs._lrelu(h) - h * s).detach())
            close(got, grad(None))
        assert any((a - b).abs().max() > 1e-3 for a, b in zip(got, own))


@pytest.mark.parametrize("kind", ["up", "fold", "down"])
def test_chain_forward_writes_its_pre_activations(rng, kind):
    """The plain forward writes each inner pre-activation on exactly its
    columns of ``pre`` (the up chain's [1, E-1), [4, E-4), [13, E-13); the
    down chain's [1, E-1), [3, E-3)) and nothing else."""
    forward, _, pre = _chain_case(rng, kind, False)
    pre.fill_(float("nan"))
    forward(pre)
    E = pre.shape[-1]
    spans = [(1, E - 1), (3, E - 3)] if kind == "down" else [(1, E - 1), (4, E - 4),
                                                             (13, E - 13)]
    assert len(spans) == pre.shape[0]
    for p, (lo, hi) in zip(pre, spans):
        assert torch.isfinite(p[..., lo:hi]).all()
        assert torch.isnan(p[..., :lo]).all() and torch.isnan(p[..., hi:]).all()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_chain_modules_hand_the_forwards_pre_activations_on(monkeypatch, rng, kind, bf16):
    """`UpChain` and `DownChain` give the forward a `chain_pre` buffer and
    their backward the same buffer, so that K and L take the forward's
    branches."""
    seen = {}
    names = ("upsample_chain", "upsample_chain_grad") if kind == "up" else (
        "downsample_chain", "downsample_chain_grad")
    for name in names:
        orig = getattr(fs, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen[_name] = k["pre"] if "pre" in k else a[-1]
            return _orig(*a, **k)

        monkeypatch.setattr(fs, name, spy)
    B, C, T = 2, 8, 300
    if kind == "up":
        xu = torch.from_numpy(_r(rng, B, C, T)).requires_grad_()
        cond = torch.from_numpy(_r(rng, B, C, T)).requires_grad_()
        ws = [torch.from_numpy(w).requires_grad_() for w in _up_weights(rng, C, 4, 0)]
        y = fs.UpChain.apply(xu, cond, *ws, None, 0, bf16)
        shape = (3, B, C, T + 2 * fs.R_UP)
    else:
        z = torch.from_numpy(_r(rng, B, C, T)).requires_grad_()
        ws = [torch.from_numpy(_r(rng, *s, scale=0.3)).requires_grad_() for s in (
            (12, C), (12, 1), (C, 3 * C), (C, 1), (C, 3 * C), (C, 1), (12, 3 * C), (12, 1))]
        y = fs.DownChain.apply(z, *ws, bf16)
        shape = (2, B, C, T + 2 * fs.R_DOWN)
    y.float().sum().backward()
    fwd, bwd = (seen[n] for n in names)
    assert fwd is bwd and tuple(fwd.shape) == shape and fwd.dtype == torch.float32


def test_chain_functions_cast_and_return_grads_in_input_dtypes(rng):
    """The bf16-operand chains store the down path in bf16 and return each
    input's gradient in that input's dtype, as the JAX package's custom_vjp
    entries do."""
    x = torch.from_numpy(_r(rng, 1, 24, 200)).requires_grad_()
    w = torch.from_numpy(_r(rng, 8, 72, scale=0.2)).requires_grad_()
    b = torch.zeros(8, 1, requires_grad=True)
    y = fs.Stem.apply(x, w, b, True)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.float32 and w.grad.dtype == torch.float32


class _Launched(RuntimeError):
    pass


@pytest.mark.parametrize("name", ["I", "J", "K", "L", "stem", "K_bf16", "L_bf16", "stem_bf16"])
def test_cuda_tensors_launch_the_kernel_or_raise(monkeypatch, rng, name):
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper launches its kernel (here a stand-in that fails, as a card
    without the library would), and the failure propagates. With bf16
    inputs K and L reach their bf16 entries (the tensor-core route), at
    widths that are not multiples of 8 (K's C 12, L's Cin 4)."""
    launched = []

    def fake_launch(kernel, *args):
        launched.append(kernel)
        raise _Launched(kernel)

    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(build, "launch", fake_launch)
    for plain in ("oscillator_amps_grad_plain", "upsample_linear_grad_plain",
                  "upsample_chain_grad_plain", "downsample_chain_grad_plain", "conv3_grad_plain"):
        for mod in (oscillator, resample, fs):
            if hasattr(mod, plain):
                monkeypatch.setattr(mod, plain, None)  # calling it would fail differently
    dt = torch.bfloat16 if name.endswith("_bf16") else torch.float32
    sfx = "_bf16" if name.endswith("_bf16") else ""
    if name == "I":
        call, kernel = (lambda: oscillator.oscillator_amps_grad(
            torch.full((1, 4), 100.0), torch.zeros(1, 15, 4 * 480))), "tvc_oscillator_amps_grad"
    elif name == "J":
        call, kernel = (lambda: resample.resample_grad(
            torch.zeros(2, 40), 10, 4, True)), "tvc_resample_grad"
    elif name.startswith("K"):
        C = 12 if sfx else 8  # bf16: a width whose copies are padded to 16 channels
        ws = [_t(w) for w in _up_weights(rng, C, 4, 0)]
        call, kernel = (lambda: fs.upsample_chain_grad(
            torch.zeros(1, C, 50, dtype=dt), torch.zeros(1, C, 50, dtype=dt), *ws,
            torch.zeros(1, 4, 50))), "tvc_up_chain_grad" + sfx
    elif name.startswith("L"):
        ws = [torch.zeros(s) for s in ((8, 4), (8, 1), (4, 12), (4, 1), (4, 12), (4, 1),
                                       (8, 12), (8, 1))]
        call, kernel = (lambda: fs.downsample_chain_grad(
            torch.zeros(1, 4, 50, dtype=dt), *ws, torch.zeros(1, 8, 50))), \
            "tvc_down_chain_grad" + sfx
    else:
        call, kernel = (lambda: fs.conv3_grad(
            torch.zeros(1, 8, 50, dtype=dt), torch.zeros(4, 24), torch.zeros(4, 1),
            torch.zeros(1, 4, 50))), "tvc_conv3_grad" + sfx
    with pytest.raises(_Launched):
        call()
    assert launched == [kernel]
