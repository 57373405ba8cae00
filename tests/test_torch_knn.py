"""Kernel H's plain version (`tinyvc_tpu_torch/kernels/knn.py`) against
`tinyvc_tpu/ops/pallas/knn.py::pallas_match_features` in interpret mode (its
default bf16x3 similarities): cos, IP and L2, alpha 0 and 0.5, a dictionary
of N=300 rows (the TPU pads it to 384 with -inf columns), five identical
rows that tie at the 4th place (ties go to the lowest index), and the
neighbours themselves against JAX's own argmax passes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu.ops.pallas.knn import pallas_match_features
from tinyvc_tpu.ops.retrieval import top_k_small as jax_top_k
from tinyvc_tpu_torch.kernels.knn import _dictionary, match_features_knn, prepared_dictionary

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
    """The wrapper prepares a dictionary (normalised rows, the L2 row, the
    bf16 copy) once and keeps it on the tensor; another metric or an
    in-place write prepares it again."""
    ref = torch.from_numpy(rng.standard_normal((N, C)).astype(np.float32))

    def fresh(got, metric):
        return all(torch.equal(a, b) for a, b in zip(got, _dictionary(ref, metric)))

    cos = prepared_dictionary(ref, "cos")
    assert fresh(cos, "cos") and prepared_dictionary(ref, "cos") is cos
    l2 = prepared_dictionary(ref, "L2")
    assert l2 is not cos and fresh(l2, "L2")
    ref.mul_(2.0)
    again = prepared_dictionary(ref, "L2")
    assert again is not l2 and fresh(again, "L2")
    assert not torch.equal(again[1], l2[1])
