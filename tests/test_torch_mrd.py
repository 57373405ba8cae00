"""The port's phase-plane MRD (`tinyvc_tpu_torch/ops/mrd_planes.py`, the
plain versions of kernels M, N and O in `tinyvc_tpu_torch/kernels/mrd.py`)
against the JAX package's plan and its fused MRD kernels
(`tinyvc_tpu/ops/pallas/mrd.py::mrd_chain`), run in interpret mode on the
CPU as `tests/test_mrd_fused.py` runs them. Inputs from a numpy seed; each
comparison prints its measured error."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu.dsp.stft import stft_magnitude as j_stft_magnitude
from jax.experimental import pallas as pl

from tinyvc_tpu.ops import mrd_planes as jmp
from tinyvc_tpu.ops.pallas.mrd import _bwd_kernel_dw, _bwd_kernel_dx, _pack_w
from tinyvc_tpu.ops.pallas.mrd import mrd_chain as j_mrd_chain
from tinyvc_tpu_torch.kernels import mrd
from tinyvc_tpu_torch.ops import mrd_planes as pmp

T = 8000
FULL = (32, 256, 4)  # channels, max_channels, num_layers
SMALL = (4, 16, 2)  # tests/test_training.py::small_config
# widths no 32-channel stage, 64- or 128-row tile or 16-deep K step divides
# (the kernels' edges); at r=128, T=2400 its Wp = 21 is odd, so plane blocks
# start at odd element offsets
RAGGED = (24, 48, 3)


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


def _chain(plan, rng):
    ws = [(0.1 * rng.standard_normal((lp.kh, lp.kw, lp.cin, lp.cout))).astype(np.float32)
          for lp in plan.layers]
    bs = [(0.1 * rng.standard_normal(lp.cout)).astype(np.float32) for lp in plan.layers]
    return ws, bs


def _spec_pm(rng, res, plan, B=2, length=T):
    x = jnp.asarray((0.3 * rng.standard_normal((B, length))).astype(np.float32))
    spec = jnp.swapaxes(j_stft_magnitude(x, res * 4, res, drop_first=False), 1, 2)
    return np.asarray(jmp.pack_spec_planes(spec, plan))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel_peak(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_outs(spec_pm, ws, bs, plan, dtype_name):
    return jax.jit(lambda s, w, b: j_mrd_chain(s, tuple(w), tuple(b), plan, dtype_name, True))(
        jnp.asarray(spec_pm), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])


def _jax_grads(spec_pm, ws, bs, plan, dtype_name):
    """JAX's custom-vjp gradients of sum_i 0.1 (i+1) sum(out_i^2)
    (`tests/test_mrd_fused.py:115-144`)."""
    def loss(s, w, b):
        outs = j_mrd_chain(s, tuple(w), tuple(b), plan, dtype_name, True)
        return sum((o.astype(jnp.float32) ** 2).sum() * (0.1 * (i + 1))
                   for i, o in enumerate(outs))

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(spec_pm), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    return [np.asarray(g[0])] + [np.asarray(a) for a in g[1]] + [np.asarray(a) for a in g[2]]


def _port_grads(spec_pm, ws, bs, plan, dtype_name):
    s = _t(spec_pm).requires_grad_()
    wt = [_t(w).requires_grad_() for w in ws]
    bt = [_t(b).requires_grad_() for b in bs]
    outs = mrd.mrd_chain(s, wt, bt, plan, dtype_name)
    loss = sum((o.float() ** 2).sum() * (0.1 * (i + 1)) for i, o in enumerate(outs))
    g = torch.autograd.grad(loss, [s, *wt, *bt])
    return [a.numpy() for a in g]


@pytest.mark.parametrize("widths", [FULL, SMALL], ids=["full", "small"])
@pytest.mark.parametrize("length", [2400, T])
@pytest.mark.parametrize("res", [32, 64, 128, 256])
def test_make_plan_matches_jax(res, length, widths):
    want = jmp.make_plan(res, length, *widths)
    got = pmp.make_plan(res, length, *widths)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for li in range(len(got.layers)):
        assert got.valid_count(li) == want.valid_count(li)
        assert got.flat_len(li) == int(np.prod(want.out_shape(li, 1)[2:]))
        np.testing.assert_array_equal(got.out_mask(li), want.out_mask(li))


@pytest.mark.parametrize("res", [32, 256])
def test_pack_and_unpack_match_jax(rng, res):
    plan = jmp.make_plan(res, T)
    spec = rng.standard_normal((2, plan.bins, plan.W)).astype(np.float32)
    want = np.asarray(jmp.pack_spec_planes(jnp.asarray(spec), plan))
    got = pmp.pack_spec_planes(_t(spec), pmp.make_plan(res, T))
    np.testing.assert_array_equal(got.numpy(), want)
    for li, lp in enumerate(plan.layers):
        y = rng.standard_normal(plan.out_shape(li, 2)).astype(np.float32)
        np.testing.assert_array_equal(
            pmp.unpack_planes(_t(y), pmp.make_plan(res, T), li).numpy(),
            np.asarray(jmp.unpack_planes(jnp.asarray(y), plan, li)))


@pytest.mark.parametrize("res, widths, length", [(32, FULL, T), (256, FULL, T),
                                                (128, RAGGED, 2400)],
                         ids=["32", "256", "128-ragged"])
def test_plain_chain_matches_jax_kernel(rng, res, widths, length):
    """Full widths, T=8000, B=2 (and the ragged widths at T=2400), fp32:
    every output within 2e-5 of its peak (the bound JAX holds its kernel to,
    `tests/test_mrd_fused.py:99-112`)."""
    plan = pmp.make_plan(res, length, *widths)
    spec_pm = _spec_pm(rng, res, plan, length=length)
    ws, bs = _chain(plan, rng)
    want = _jax_outs(spec_pm, ws, bs, jmp.make_plan(res, length, *widths), "float32")
    got = mrd.mrd_chain(_t(spec_pm), [_t(w) for w in ws], [_t(b) for b in bs], plan, "float32")
    errs = [_rel_peak(g.numpy(), np.asarray(w).reshape(g.shape)) for g, w in zip(got, want)]
    print(f"r={res} widths {widths}: fp32 plain chain vs JAX kernel, max error of the peak per "
          "layer " + ", ".join(f"{e:.2e}" for e in errs))
    assert max(errs) <= 2e-5
    for li, g in enumerate(got):  # exact zeros off the valid positions
        off = torch.from_numpy(plan.out_mask(li).reshape(-1)) == 0
        assert float(g[:, :, off].abs().max()) == 0.0


def test_plain_gradients_match_jax_vjp(rng):
    """r=64, full widths: dspec, every dW and db within 3e-5 of the peak of
    JAX's custom vjp (`tests/test_mrd_fused.py:115-144`)."""
    res = 64
    plan = pmp.make_plan(res, T)
    spec_pm = _spec_pm(rng, res, plan)
    ws, bs = _chain(plan, rng)
    want = _jax_grads(spec_pm, ws, bs, jmp.make_plan(res, T), "float32")
    got = _port_grads(spec_pm, ws, bs, plan, "float32")
    errs = [_rel_peak(g, w) for g, w in zip(got, want)]
    print("fp32 gradients vs JAX's vjp, max error of the peak: dspec "
          f"{errs[0]:.2e}, dW " + ", ".join(f"{e:.2e}" for e in errs[1:7])
          + ", db " + ", ".join(f"{e:.2e}" for e in errs[7:]))
    assert max(errs) <= 3e-5


# bf16 operands, relative L2 per output and per gradient: the port and JAX
# round the same operands to bf16 and sum in fp32 in another order, so a
# sum that straddles a bf16 rounding lands one bf16 step away and the step
# carries into the later layers. Measured here (r=64, full widths): outputs
# 0 (layer 0) to 1.7e-3 (the logits), gradients 8e-5 to 1.2e-4 (dW, db) and
# 3.0e-3 (dspec, stored in bf16); JAX's own bf16 run is 3.0e-3 to 8.5e-3
# (outputs) and 1.0e-3 to 5.7e-3 (gradients) from its fp32 run. The bound is
# 5e-3, and the port must also stay nearer JAX's bf16 run than JAX's bf16
# run is to its fp32 one.
BF16_REL_L2 = 5e-3


def test_bf16_plain_chain_matches_jax_kernel(rng):
    res = 64
    plan = pmp.make_plan(res, T)
    jplan = jmp.make_plan(res, T)
    spec_pm = _spec_pm(rng, res, plan)
    ws, bs = _chain(plan, rng)
    want = _jax_outs(spec_pm, ws, bs, jplan, "bfloat16")
    want32 = _jax_outs(spec_pm, ws, bs, jplan, "float32")
    got = mrd.mrd_chain(_t(spec_pm), [_t(w) for w in ws], [_t(b) for b in bs], plan, "bfloat16")
    assert all(g.dtype == torch.bfloat16 for g in got)
    errs = [_rel_l2(g.float().numpy(), np.asarray(w, np.float32).reshape(g.shape))
            for g, w in zip(got, want)]
    jax_own = [_rel_l2(np.asarray(a, np.float32), np.asarray(b)) for a, b in zip(want, want32)]
    print("bf16 outputs, relative L2 to JAX's bf16 run "
          + ", ".join(f"{e:.2e}" for e in errs) + "; JAX's bf16 run to its fp32 run "
          + ", ".join(f"{e:.2e}" for e in jax_own))
    assert max(errs) <= BF16_REL_L2
    assert all(e <= j for e, j in zip(errs, jax_own))

    gw = _jax_grads(spec_pm, ws, bs, jplan, "bfloat16")
    gw32 = _jax_grads(spec_pm, ws, bs, jplan, "float32")
    gg = _port_grads(spec_pm, ws, bs, plan, "bfloat16")
    gerrs = [_rel_l2(g, w) for g, w in zip(gg, gw)]
    gown = [_rel_l2(a, b) for a, b in zip(gw, gw32)]
    print("bf16 gradients (dspec, dW, db), relative L2 to JAX's bf16 vjp "
          + ", ".join(f"{e:.2e}" for e in gerrs) + "; JAX's bf16 vjp to its fp32 vjp "
          + ", ".join(f"{e:.2e}" for e in gown))
    assert max(gerrs) <= BF16_REL_L2
    assert all(e <= j for e, j in zip(gerrs, gown))


def test_plain_dx_and_dw_equal_autograd_of_the_plain_chain(rng):
    """In fp32 the written-out plain versions of N and O are autograd
    through the plain chain (small widths, r=32, T=2400)."""
    plan = pmp.make_plan(32, 2400, *SMALL)
    spec_pm = _t(_spec_pm(rng, 32, jmp.make_plan(32, 2400, *SMALL), length=2400))
    ws, bs = _chain(plan, rng)
    ws = [_t(w).requires_grad_() for w in ws]
    bs = [_t(b).requires_grad_() for b in bs]
    s = spec_pm.clone().requires_grad_()
    outs = pmp.mrd_chain_xla(s, ws, bs, plan)
    cots = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32)) for o in outs]
    want = torch.autograd.grad(outs, [s, *ws, *bs], cots)
    B = s.shape[0]
    flat = [c.reshape(B, c.shape[1], -1) for c in cots]
    dspec, dys = mrd.mrd_dx_plain(flat, [w.detach() for w in ws], plan)
    xs = [s.detach().reshape(B, 1, -1)] + [o.detach().reshape(B, o.shape[1], -1)
                                            for o in outs[:-1]]
    dws, dbs = mrd.mrd_dw_plain(xs, dys, plan)
    for g, w in zip([dspec.reshape(s.shape), *dws, *dbs], want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def _jax_dx_kernel(cots, ws, plan):
    """JAX's `_bwd_kernel_dx` in interpret mode, as `_mrd_bwd`'s first pass
    runs it: fp32 cotangents -> (dspec, the masked cotangents dy)."""
    B = cots[0].shape[0]
    flat = [jnp.asarray(c) for c in cots]
    w_in = [_pack_w(jnp.asarray(w)) for w in ws]
    blk = lambda a: pl.BlockSpec((1,) + a.shape[1:], lambda b: (b,) + (0,) * (a.ndim - 1))  # noqa: E731
    wblk = lambda w: pl.BlockSpec(w.shape, lambda b: (0,) * w.ndim)  # noqa: E731
    spec_len = plan.s0 * (plan.layers[0].g_in + 4) * plan.Wp
    outs = pl.pallas_call(
        functools.partial(_bwd_kernel_dx, plan, jnp.float32),
        grid=(B,),
        in_specs=[blk(c) for c in flat] + [wblk(w) for w in w_in],
        out_specs=[pl.BlockSpec((1, 1, spec_len), lambda b: (b, 0, 0))] + [blk(c) for c in flat],
        out_shape=[jax.ShapeDtypeStruct((B, 1, spec_len), jnp.float32)]
        + [jax.ShapeDtypeStruct(c.shape, jnp.float32) for c in flat],
        interpret=True,
    )(*flat, *w_in)
    return np.asarray(outs[0]), [np.asarray(o) for o in outs[1:]]


@pytest.mark.parametrize("res", [32, 256])
def test_plain_dx_matches_jax_bwd_kernel_dx(rng, res):
    """The plain N forms dy with a select, as the kernel does, where JAX's
    `_bwd_kernel_dx` multiplies by the mask: on finite cotangents dspec and
    every dy agree within 3e-5 of their peaks (full widths, T=2400, B=2,
    fp32; the sums run in another order)."""
    plan = pmp.make_plan(res, 2400)
    B = 2
    cots = [rng.standard_normal((B, lp.cout, plan.flat_len(li))).astype(np.float32)
            for li, lp in enumerate(plan.layers)]
    ws, _ = _chain(plan, rng)
    want = _jax_dx_kernel(cots, ws, jmp.make_plan(res, 2400))
    dspec, dys = mrd.mrd_dx_plain([_t(c) for c in cots], [_t(w) for w in ws], plan)
    errs = [_rel_peak(dspec.numpy(), want[0])] + [_rel_peak(g.numpy(), w)
                                                   for g, w in zip(dys, want[1])]
    print(f"r={res}: plain N vs JAX's _bwd_kernel_dx, max error of the peak (dspec, dy) "
          + ", ".join(f"{e:.2e}" for e in errs))
    assert max(errs) <= 3e-5


def _jax_dw_kernel(xs, dys, plan, dtype):
    """JAX's `_bwd_kernel_dw` in interpret mode, as `_mrd_bwd`'s second pass
    runs it (one `pl.pallas_call`, the dW and db blocks revisited across the
    batch grid): each layer's flat input and dy -> (dW [kh*kw, cin, cout],
    db [1, cout]) per layer, fp32."""
    B = xs[0].shape[0]
    x_in = [jnp.asarray(x, dtype) for x in xs]
    d_in = [jnp.asarray(d, dtype) for d in dys]
    blk = lambda a: pl.BlockSpec((1,) + a.shape[1:], lambda b: (b,) + (0,) * (a.ndim - 1))  # noqa: E731
    wblk = lambda s: pl.BlockSpec(s.shape, lambda b: (0,) * len(s.shape))  # noqa: E731
    dw_shapes = [jax.ShapeDtypeStruct((lp.kh * lp.kw, lp.cin, lp.cout), jnp.float32)
                 for lp in plan.layers]
    db_shapes = [jax.ShapeDtypeStruct((1, lp.cout), jnp.float32) for lp in plan.layers]
    outs = pl.pallas_call(
        functools.partial(_bwd_kernel_dw, plan, dtype, B),
        grid=(B,),
        in_specs=[blk(x) for x in x_in] + [blk(d) for d in d_in],
        out_specs=[wblk(s) for s in dw_shapes] + [wblk(s) for s in db_shapes],
        out_shape=dw_shapes + db_shapes,
        interpret=True,
    )(*x_in, *d_in)
    nl = len(plan.layers)
    return [np.asarray(o) for o in outs[:nl]], [np.asarray(o) for o in outs[nl:]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("res", [32, 256])
def test_plain_dw_matches_jax_bwd_kernel_dw(rng, res, dtype):
    """The plain O against JAX's `_bwd_kernel_dw` on the same inputs (full
    widths, T=2400, B=2; random maps and cotangents masked as N forms
    them): every dW and db element within 1e-5 of the sum of its terms'
    magnitudes, sum |x| |dy| (sum |dy| for db), the scale the sums'
    rounding in another order is proportional to (`chip_smoke.py`'s
    `MRD_TOL["sum"]`). Under bf16 both sides take the same bf16 operands,
    whose products are exact in fp32."""
    plan = pmp.make_plan(res, 2400)
    B = 2
    xs = [rng.standard_normal((B, lp.cin, plan.layers[li].s_in * plan.buf_len(li)))
          .astype(np.float32) for li, lp in enumerate(plan.layers)]
    dys = [(rng.standard_normal((B, lp.cout, plan.flat_len(li)))
            * plan.out_mask(li).reshape(-1)).astype(np.float32)
           for li, lp in enumerate(plan.layers)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want_dw, want_db = _jax_dw_kernel(xs, dys, jmp.make_plan(res, 2400), jdt)
    xt = [_t(x).to(dtype) for x in xs]
    dt = [_t(d).to(dtype) for d in dys]
    dws, dbs = mrd.mrd_dw_plain(xt, dt, plan)
    mag_w, mag_b = mrd.mrd_dw_plain([x.float().abs() for x in xt], [d.float().abs() for d in dt],
                                    plan)
    errs = []
    for li, lp in enumerate(plan.layers):
        gw = dws[li].numpy().reshape(lp.kh * lp.kw, lp.cin, lp.cout)
        mw = mag_w[li].numpy().reshape(gw.shape)
        errs.append(float((np.abs(gw - want_dw[li]) / np.maximum(mw, 1e-30)).max()))
    for li in range(len(plan.layers)):
        errs.append(float((np.abs(dbs[li].numpy() - want_db[li].reshape(-1))
                           / np.maximum(mag_b[li].numpy(), 1e-30)).max()))
    print(f"r={res} {dtype}: plain O vs JAX's _bwd_kernel_dw, max error of the sum of |terms| "
          "(dW, db) " + ", ".join(f"{e:.2e}" for e in errs))
    assert max(errs) <= 1e-5


def _valid_positions(plan, li, B):
    """1 at each (b, q, l) of layer ``li`` that lies in plane q's valid rows,
    ``l < valid_out[q] * Wp``, the positions bf16 O sums."""
    lp = plan.layers[li]
    m = np.zeros((B, lp.s_out, lp.g_out * plan.Wp), np.int64)
    for q, v in enumerate(lp.valid_out):
        m[:, q, :v * plan.Wp] = 1
    return m


@pytest.mark.parametrize("res", [32, 64, 128, 256])
def test_dw_split_schedule_covers_every_position_once(res):
    """bf16 O's split schedule (`kernels/mrd.py::dw_schedule`, the kernel's
    walk mirrored by `dw_split_chunks`) at the post-join crop (full widths,
    T=8000, B=16): across the splits of every tensor-core layer, each
    position of each plane's valid rows falls in exactly one split's chunks
    and none outside them does; each split sums at least one chunk; the
    layer's grid comes within a factor 1.5 of ``DW_FILL`` blocks, and not
    over it. The
    width-1 layers take one partial per block of their gathers."""
    plan = pmp.make_plan(res, T)
    B = 16
    parts = mrd.dw_schedule(plan, B)
    assert len(parts) == len(plan.layers)
    mma = 0
    for li, lp in enumerate(plan.layers):
        if lp.cin == 1 or lp.cout == 1:
            assert parts[li] == B * sum(mrd.dw_plane_chunks(plan, li, mrd.DW_GATHER))
            continue
        mma += 1
        seen = np.zeros((B, lp.s_out, lp.g_out * plan.Wp), np.int64)
        for s in range(parts[li]):
            chunks = mrd.dw_split_chunks(plan, li, B, s)
            assert chunks
            for b, q, l0 in chunks:
                end = min(l0 + mrd.DW_BK, lp.valid_out[q] * plan.Wp)
                assert l0 < end
                seen[b, q, l0:end] += 1
        np.testing.assert_array_equal(seen, _valid_positions(plan, li, B))
        bm = 32 if lp.cin <= 32 else 64
        blocks = parts[li] * lp.kh * -(-lp.cin // bm) * -(-lp.cout // mrd.DW_BN)
        assert mrd.DW_FILL / 1.5 <= blocks <= mrd.DW_FILL, (li, blocks)
    assert mma == 4


def _launcher_workspace(dims, layers):
    """What `tvc_mrd_dw_bf16` (`csrc/mrd_dw.cu`) requires of its
    arguments, mirrored: per layer the MRD layer arguments and its partials
    (a tensor-core layer's splits in [1, its chunks of 128 positions]; a
    width-1 layer's B times its passes of 256), and the workspace exactly
    the partials' floats, kh*3*cin*cout + cout each. The chunk and pass
    sizes are the source's ``DW_BK`` and ``GW_POS``."""
    need = 0
    for li in range(layers):
        (B, cin, cout, kh, stride, ph, s_in, s_out, g_in, g_out, Wp, W, h_in, h_out,
         parts) = dims[15 * li:15 * li + 15]
        rows = [(h_out - q + s_out - 1) // s_out if q < h_out else 0 for q in range(s_out)]
        if cin > 1 and cout > 1:
            chunks = B * sum(-(-r * Wp // 128) for r in rows)
            assert 1 <= parts <= max(chunks, 1)
        else:
            assert parts == B * sum(-(-r * Wp // 256) for r in rows)
        need += parts * (kh * 3 * cin * cout + cout)
    return need


@pytest.mark.parametrize("res, widths, B", [(32, FULL, 16), (128, RAGGED, 3)],
                         ids=["32-full", "128-ragged"])
def test_dw_wrapper_allocates_what_the_launcher_checks(monkeypatch, res, widths, B):
    """bf16 O's wrapper, its launch intercepted: the workspace it allocates
    is the size it passes, and the size the launcher's check requires from
    the dims it passes; the tensor-core layers pass the position-major
    copies, the width-1 layers the plane-major maps; without the copies it
    refuses."""
    plan = pmp.make_plan(res, 8000 if res == 32 else 2400, *widths)
    nl = len(plan.layers)
    bf = torch.bfloat16
    xs = [torch.empty((B, lp.cin, mrd._in_len(plan, li)), dtype=bf)
          for li, lp in enumerate(plan.layers)]
    dys = [torch.empty((B, lp.cout, plan.flat_len(li)), dtype=bf)
           for li, lp in enumerate(plan.layers)]
    mma = [lp.cin > 1 and lp.cout > 1 for lp in plan.layers]
    xts = [torch.empty((B, mrd._in_len(plan, li), -(-lp.cin // 32) * 32), dtype=bf)
           if mma[li] else None for li, lp in enumerate(plan.layers)]
    dyts = [torch.empty((B, plan.flat_len(li), -(-lp.cout // 32) * 32), dtype=bf)
            if mma[li] else None for li, lp in enumerate(plan.layers)]
    calls = []
    monkeypatch.setattr(mrd.build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(mrd.build, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(mrd.build, "launch", lambda name, t, *args: calls.append((name, args)))
    before = mrd.mrd_dw.launches_bf16
    dws, dbs = mrd.mrd_dw(xs, dys, plan, xts, dyts)
    assert [c[0] for c in calls] == ["tvc_mrd_dw_bf16"] and mrd.mrd_dw.launches_bf16 == before + 1
    ptrs, dims, layers, work, ws_len = calls[0][1]
    assert layers == nl and len(dims) == 15 * nl and len(ptrs) == 6 * nl
    assert work.numel() == ws_len == mrd.dw_workspace(plan, B)
    assert ws_len == _launcher_workspace(list(dims), nl)
    for li in range(nl):
        x, xt, dy, dyt, dw, db = ptrs[6 * li:6 * li + 6]
        if mma[li]:
            assert (x, xt, dy, dyt) == (None, xts[li].data_ptr(), None, dyts[li].data_ptr())
        else:
            assert (x, xt, dy, dyt) == (xs[li].data_ptr(), None, dys[li].data_ptr(), None)
        assert (dw, db) == (dws[li].data_ptr(), dbs[li].data_ptr())
    with pytest.raises(ValueError, match="position-major copies"):
        mrd.mrd_dw(xs, dys, plan)


def _rows_kernel_n_writes(plan, li):
    """0/1 over layer ``li``'s flat input: the positions of the fp32 dx that
    kernel N computes and carries to layer ``li - 1`` (``li >= 1``), rows
    ``[2, 2 + valid rows of layer li - 1's plane)`` of each plane."""
    lp, below = plan.layers[li], plan.layers[li - 1]
    m = torch.zeros((lp.s_in, lp.g_in + 4, plan.Wp))
    for phi in range(lp.s_in):
        m[phi, 2:2 + below.valid_out[phi]] = 1.0
    return m.reshape(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("res", [32, 256])
def test_dx_rows_the_kernel_skips_are_never_read(rng, res, dtype):
    """Kernel N computes dx only on the rows the layer below reads
    (`csrc/mrd_dx.cu`: in fp32 it carries only those down, in bf16 its
    epilogue forms the layer below's dy from them). The plain N layer by
    layer with every other position of that dx set to NaN gives dspec and
    every dy finite and equal to `mrd_dx_plain`'s (full widths, T=2400,
    B=2)."""
    plan = pmp.make_plan(res, 2400)
    B = 2
    cots = [torch.from_numpy(rng.standard_normal((B, lp.cout, plan.flat_len(li)))
                             .astype(np.float32)).to(dtype)
            for li, lp in enumerate(plan.layers)]
    ws = [_t(w) for w in _chain(plan, rng)[0]]
    want_dspec, want_dys = mrd.mrd_dx_plain(cots, ws, plan)
    above, dys, skipped = None, [None] * len(plan.layers), 0
    for li in range(len(plan.layers) - 1, -1, -1):
        dys[li], dx = mrd.mrd_dx_layer_plain(cots[li], above, ws[li], plan, li)
        if li > 0:
            written = _rows_kernel_n_writes(plan, li) != 0
            skipped += int((~written).sum())
            above = torch.where(written, dx, torch.full_like(dx, float("nan")))
    dspec = dx.to(dtype)
    assert skipped > 0
    for got, want in zip([dspec] + dys, [want_dspec] + want_dys):
        assert bool(torch.isfinite(got.float()).all())
        assert torch.equal(got, want)


def test_wrappers_refuse_mixed_devices(rng):
    plan = pmp.make_plan(32, 2400, *SMALL)
    ws, bs = _chain(plan, rng)
    spec = torch.zeros((1, 1, plan.s0 * plan.buf_len(0)))
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        mrd.mrd_forward(spec.to("meta"), [_t(w) for w in ws], [_t(b) for b in bs], plan)
