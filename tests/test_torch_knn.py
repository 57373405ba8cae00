"""Kernel H's plain version (`tinyvc_tpu_torch/kernels/knn.py`) against
`tinyvc_tpu/ops/pallas/knn.py::pallas_match_features` in interpret mode (its
default bf16x3 similarities): cos, IP and L2, alpha 0 and 0.5, a dictionary
of N=300 rows (the TPU pads it to 384 with -inf columns), five identical
rows that tie at the 4th place (ties go to the lowest index), and the
neighbours themselves against JAX's own argmax passes. Kernel H's
schedule (`knn_schedule`), its workspace, and its per-slice top-k and
merge, mirrored in plain torch."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu.ops.pallas.knn import pallas_match_features
from tinyvc_tpu.ops.retrieval import top_k_small as jax_top_k
from tinyvc_tpu_torch.kernels import knn
from tinyvc_tpu_torch.kernels.knn import (_kernel_dictionary, knn_schedule, match_features_knn,
                                          match_features_knn_plain, prepared_dictionary)
from tinyvc_tpu_torch.ops.retrieval import top_k_small

N, C = 300, 64
TIED = (3, 50, 100, 150, 200)  # one row, five times: the 5th must lose


def _data(rng):
    ref = rng.standard_normal((N, C)).astype(np.float32)
    ref[list(TIED)] = ref[TIED[0]]
    src = rng.standard_normal((2, 40, C)).astype(np.float32)
    src[0, 0] = ref[TIED[0]]  # its four nearest are four of the tied rows
    src[1, 5] = 0.5 * ref[TIED[0]] + 0.01 * src[1, 5]
    return src, ref


def _jax_neighbours(src, ref, metric):
    """JAX's argmax passes over the similarities that the Pallas kernel
    ranks (exact fp32 here)."""
    x, r = jnp.asarray(src), jnp.asarray(ref)
    if metric == "cos":
        x = x / (jnp.sqrt(jnp.sum(x * x, -1, keepdims=True)) + 1e-6)
        r = r / (jnp.sqrt(jnp.sum(r * r, -1, keepdims=True)) + 1e-6)
    sims = jnp.einsum("btc,nc->btn", x, r, precision="highest")
    if metric == "L2":
        sims = 2.0 * sims - jnp.sum(r * r, -1)[None, None, :]
    return np.asarray(jax_top_k(sims, 4)[1])


@pytest.mark.parametrize("metric", ("cos", "IP", "L2"))
@pytest.mark.parametrize("alpha", (0.0, 0.5))
def test_plain_against_pallas(rng, metric, alpha):
    src, ref = _data(rng)
    got, idx = match_features_knn(torch.from_numpy(src), torch.from_numpy(ref), k=4,
                                  alpha=alpha, metric=metric, return_indices=True)
    np.testing.assert_array_equal(idx.numpy(), _jax_neighbours(src, ref, metric))
    # the query row equals the tied row: the four lowest of the five win
    assert idx[0, 0].tolist() == list(TIED[:4])
    want = np.asarray(pallas_match_features(src, ref, k=4, alpha=alpha, metric=metric,
                                            interpret=True))
    # the same neighbours: the mean of the same bf16 rows, summed in fp32;
    # the sums' order may differ, so 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_mean_uses_bf16_rows(rng):
    """The kernel's mean is of bf16-rounded rows: not the fp32 mean of
    `ops/retrieval.py`, by up to half a bf16 step of the rows."""
    from tinyvc_tpu_torch.ops.retrieval import match_features

    src, ref = _data(rng)
    got = match_features_knn(torch.from_numpy(src), torch.from_numpy(ref)).numpy()
    fp32 = match_features(torch.from_numpy(src), torch.from_numpy(ref)).numpy()
    diff = np.abs(got - fp32).max()
    assert 0 < diff <= 2.0**-9 * np.abs(ref).max()


def test_prepared_dictionary_is_kept_until_written(rng):
    """The wrapper prepares a dictionary (normalised rows, transposed and
    padded for kernel H, the L2 row, the bf16 copy) once and keeps it on the
    tensor; another metric or an in-place write prepares it again."""
    ref = torch.from_numpy(rng.standard_normal((N, C)).astype(np.float32))

    def fresh(got, metric):
        return all(torch.equal(a, b) for a, b in zip(got, _kernel_dictionary(ref, metric)))

    cos = prepared_dictionary(ref, "cos")
    assert fresh(cos, "cos") and prepared_dictionary(ref, "cos") is cos
    l2 = prepared_dictionary(ref, "L2")
    assert l2 is not cos and fresh(l2, "L2")
    ref.mul_(2.0)
    again = prepared_dictionary(ref, "L2")
    assert again is not l2 and fresh(again, "L2")
    assert not torch.equal(again[1], l2[1])


def test_kernel_dictionary_layout(rng):
    """Kernel H's dictionary: the similarity rows as columns of [C, N]
    padded with zero columns to a multiple of 64."""
    ref = torch.from_numpy(rng.standard_normal((N, C)).astype(np.float32))
    ref_t, row, ref_mean = _kernel_dictionary(ref, "cos")
    assert ref_t.shape == (C, 320) and ref_t.is_contiguous()
    norm = ref / (torch.sqrt(torch.sum(ref * ref, dim=1, keepdim=True)) + 1e-6)
    assert torch.equal(ref_t[:, :N], norm.T) and not ref_t[:, N:].any()


# (R, N): serving B=1 and B=8 against the two-speaker dictionary, a ragged
# dictionary smaller than a slice, ragged R and N, a dictionary over
# MAX_SPLIT tiles (slices of several tiles)
SCHEDULE_CASES = [(320, 2048), (2560, 2048), (80, 300), (74, 40), (1, 1), (600, 2200),
                  (333, 4097), (7, 64), (5000, 65), (64, 130000)]


@pytest.mark.parametrize("R, Nd", SCHEDULE_CASES)
def test_schedule_covers_every_dictionary_row_once(R, Nd):
    rows, slice_, nsplit = knn_schedule(R, Nd)
    assert rows in (32, 64) and slice_ % knn.TILE == 0
    assert 1 <= nsplit <= knn.MAX_SPLIT
    covered = np.zeros(Nd, dtype=int)
    for s in range(nsplit):
        lo, hi = s * slice_, min(Nd, (s + 1) * slice_)
        assert lo < hi  # no empty slice
        covered[lo:hi] += 1
    assert (covered == 1).all()
    blocks = -(-R // rows) * nsplit
    if rows == 64:  # the 4-warp tile only when its blocks fill the card twice
        assert blocks >= knn.FILL


def test_schedule_fills_the_card_at_serving_shapes():
    """At least two blocks an SM of the H100's 132 at B=1 (R=320) against
    the 2048-row dictionary; the 4-warp tile at B=8."""
    assert knn_schedule(320, 2048) == (32, 64, 32)  # 10 x 32 = 320 blocks
    assert knn_schedule(2560, 2048) == (64, 64, 32)  # 40 x 32 blocks


def _source_schedule(R, Nd):
    """`csrc/knn.cu::schedule` and `padded`, from its own constants: the
    nsplit its entry accepts and the padded rows of xT and refT."""
    src = open(os.path.join(os.path.dirname(knn.__file__), "csrc", "knn.cu")).read()

    def const(name):
        return eval(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1))

    bn, pad, fill, max_split = const("BN"), const("PAD"), const("FILL"), const("MAX_SPLIT")
    nt = (Nd + bn - 1) // bn
    per = (nt + max_split - 1) // max_split
    return (nt + per - 1) // per, (R + pad - 1) // pad * pad, (Nd + pad - 1) // pad * pad, fill


@pytest.mark.parametrize("B, T, Nd, k", [(1, 320, 2048, 4), (2, 37, 300, 7), (8, 320, 2048, 4),
                                         (1, 3, 4097, 2)])
def test_wrapper_allocates_what_the_launcher_checks(monkeypatch, rng, B, T, Nd, k):
    """Kernel H's wrapper, its launch intercepted: the candidate workspace
    is [nsplit, R, k] with the nsplit that the C entry computes and checks
    (its schedule from the source's constants), the source's transposed
    copy [C, pad64(R)], the dictionary's [C, pad64(N)]."""
    Cs = 24
    src = torch.from_numpy(rng.standard_normal((B, T, Cs)).astype(np.float32))
    ref = torch.from_numpy(rng.standard_normal((Nd, Cs)).astype(np.float32))
    calls = []
    monkeypatch.setattr(knn.build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(knn.build, "check_input", lambda *a, **kw: None)
    monkeypatch.setattr(knn.build, "launch", lambda name, t, *args: calls.append((name, args)))
    # restored after the test: other tests expect the counter unmoved
    monkeypatch.setattr(match_features_knn, "launches", match_features_knn.launches)
    before = match_features_knn.launches
    match_features_knn(src, ref, k=k, metric="L2")
    assert [c[0] for c in calls] == ["tvc_knn"] and match_features_knn.launches == before + 1
    (x, x_t, ref_t, row, ref_mean, cand_v, cand_i, out, idx, R, n, c, kk, metric, nsplit,
     _, _) = calls[0][1]
    want_split, rp, np_, fill = _source_schedule(B * T, Nd)
    assert fill == knn.FILL and (R, n, c, kk, metric) == (B * T, Nd, Cs, k, 2)
    assert nsplit == want_split == knn_schedule(R, Nd)[2]
    assert cand_v.shape == cand_i.shape == (nsplit, R, k)
    assert cand_v.dtype == torch.float32 and cand_i.dtype == torch.int32
    assert x_t.shape == (Cs, rp) and ref_t.shape == (Cs, np_) and ref_mean.dtype == torch.bfloat16
    assert out.shape == (B, T, Cs) and idx.shape == (B, T, k)


def _sliced_top_k(sims, k, slice_, nsplit):
    """Kernel H's selection in plain torch: each slice's k best by (value
    desc, index asc), then the merge of the slices' lists by the same
    order."""
    vals, idxs = [], []
    for s in range(nsplit):
        lo = s * slice_
        part = sims[..., lo:lo + slice_]
        kk = min(k, part.shape[-1])
        v, i = top_k_small(part, kk)
        vals.append(v)
        idxs.append(i + lo)
    v, i = torch.cat(vals, -1), torch.cat(idxs, -1)
    # (value desc, index asc): sort by index, then stably by value
    order = torch.argsort(i, dim=-1)
    v, i = v.gather(-1, order), i.gather(-1, order)
    order = torch.argsort(-v, dim=-1, stable=True)
    return v.gather(-1, order)[..., :k], i.gather(-1, order)[..., :k]


@pytest.mark.parametrize("metric", ("cos", "IP", "L2"))
@pytest.mark.parametrize("k", (1, 4, 8))
def test_sliced_top_k_then_merge_is_the_global_top_k(rng, metric, k):
    """Per-slice k best and a merge give the plain version's k argmax
    passes, the five-way tie of `_data` included (it spans four slices):
    the same neighbours in the same order."""
    src, ref = _data(rng)
    s, r = torch.from_numpy(src), torch.from_numpy(ref)
    _, want = match_features_knn_plain(s, r, k=k, metric=metric, return_indices=True)
    ref_sim, row, _ = knn._dictionary(r, metric)
    xn = s / (torch.sqrt(torch.sum(s * s, dim=-1, keepdim=True)) + 1e-6) if metric == "cos" else s
    sims = torch.matmul(xn, ref_sim.T)
    if metric == "L2":
        sims = 2.0 * sims + row
    _, slice_, nsplit = knn_schedule(src.shape[0] * src.shape[1], N)
    assert nsplit == 5 and {t // slice_ for t in TIED} == {0, 1, 2, 3}
    _, got = _sliced_top_k(sims, k, slice_, nsplit)
    assert torch.equal(got, want)
    if k == 4:
        assert got[0, 0].tolist() == list(TIED[:4])
