"""kNN feature matching with the dictionary's rows sharded over the mesh's
``model`` axis (counterpart of `tinyvc_tpu/parallel/sharded_knn.py`).

Each rank holds one shard ``[N / S, C]`` of the padded dictionary
(:func:`pad_dictionary`, :func:`dictionary_shard`) and takes the top k of
its own similarities (``ops/retrieval.py::_similarities``, ``torch.matmul``
in fp32: JAX computes this product outside any Pallas kernel, and kernel H
is not on this path in JAX either). Two layouts resolve the global top k:

* ``payload="index"`` (default): gather only the k similarity values of
  every shard, take the same re-top-k over the shard-major candidates on
  every rank, sum the winning vectors each rank owns, one ``all_reduce``
  of the sums, then divide by k.
* ``payload="vectors"``: gather the values and the neighbour vectors, then
  the re-top-k and the mean.

Ties go to the lowest candidate index, as ``jax.lax.top_k`` breaks them
(`ops/retrieval.py::top_k_small`). Padding rows are masked to -inf.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ops.retrieval import _similarities, top_k_small
from .mesh import Mesh


def pad_dictionary(dictionary: torch.Tensor, num_shards: int,
                   k: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[N, C]`` padded with zero rows so that each of ``num_shards``
    shards holds at least ``k`` rows and all hold the same count -> (padded,
    valid mask ``[N']``). Requires ``N >= k``."""
    n = dictionary.shape[0]
    if n < k:
        raise ValueError(f"dictionary has {n} rows; sharded kNN needs >= k={k}")
    target = max(k * num_shards, -(-n // num_shards) * num_shards)
    mask = torch.arange(target, device=dictionary.device) < n
    if target > n:
        dictionary = torch.cat([dictionary, dictionary.new_zeros(target - n,
                                                                 dictionary.shape[1])])
    return dictionary, mask


def dictionary_shard(padded: torch.Tensor, mask: torch.Tensor,
                     mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows (its model index's slice) of a padded dictionary
    and of its mask: what a rank holds."""
    n = padded.shape[0] // mesh.model
    rows = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
    return padded[rows].contiguous(), mask[rows].contiguous()


def _local_topk(source, dict_shard, mask_shard, k, metric):
    """source ``[B, T, C]``, shard ``[Nl, C]``, mask ``[Nl]`` -> (values
    ``[B, T, k]``, the neighbour vectors ``[B, T, k, C]``)."""
    sims = _similarities(source, dict_shard, metric)
    sims = torch.where(mask_shard, sims, torch.tensor(float("-inf"), device=sims.device))
    vals, idx = top_k_small(sims, k)
    return vals, dict_shard[idx]


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` of every rank of the model group, stacked shard-major and
    moved behind the frames: ``[B, T, k, ...]`` -> ``[B, T, S * k, ...]``."""
    parts = [torch.empty_like(x) for _ in range(mesh.model)]
    dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
    stacked = torch.stack(parts, dim=2)  # [B, T, S, k, ...]
    return stacked.reshape(x.shape[0], x.shape[1], -1, *x.shape[3:])


def _match_index_payload(source, dict_shard, mask_shard, k, metric, mesh):
    vals, vecs = _local_topk(source, dict_shard, mask_shard, k, metric)
    _, top = top_k_small(_gather(vals, mesh), k)  # [B, T, k] in [0, S*k), the same on every rank
    mine = (top // k == mesh.model_index)[..., None]
    sel = torch.gather(vecs, 2, (top % k)[..., None].expand(-1, -1, -1, vecs.shape[-1]))
    total = torch.sum(torch.where(mine, sel, torch.zeros((), device=sel.device)), dim=2)
    dist.all_reduce(total, group=mesh.model_group)
    return (total / k).to(source.dtype)


def _match_vector_payload(source, dict_shard, mask_shard, k, metric, mesh):
    vals, vecs = _local_topk(source, dict_shard, mask_shard, k, metric)
    cand_vecs = _gather(vecs, mesh)  # [B, T, S*k, C]
    _, top = top_k_small(_gather(vals, mesh), k)
    neigh = torch.gather(cand_vecs, 2, top[..., None].expand(-1, -1, -1, cand_vecs.shape[-1]))
    return neigh.mean(dim=2).to(source.dtype)


def sharded_match_features(mesh: Mesh, source: torch.Tensor, dictionary: torch.Tensor,
                           mask: torch.Tensor, k: int = 4, alpha: float = 0.0,
                           metric: str = "cos", payload: str = "index") -> torch.Tensor:
    """source ``[B, T, C]`` (this rank's rows), ``dictionary`` ``[N / S,
    C]`` and ``mask`` ``[N / S]`` this rank's shard (:func:`dictionary_shard`)
    -> matched ``[B, T, C]``, the same on every rank of the model group."""
    impl = {"index": _match_index_payload, "vectors": _match_vector_payload}[payload]
    result = impl(source, dictionary, mask, k, metric, mesh)
    if alpha == 0.0:
        return result
    return result * (1.0 - alpha) + source * alpha
