"""kNN feature matching (counterpart of `tinyvc_tpu/ops/retrieval.py`).

Each source frame becomes the mean of its k nearest dictionary frames,
blended with the source by ``alpha``. The similarity product is
``torch.matmul`` in fp32 (the JAX package leaves it to XLA on this path);
the caller keeps TF32 off, since a 1e-3 perturbation flips neighbours.
"""

from __future__ import annotations

import torch


def _similarities(source: torch.Tensor, reference: torch.Tensor, metric: str) -> torch.Tensor:
    """source ``[B, T, C]``, reference ``[N, C]`` or ``[B, N, C]`` ->
    ``[B, T, N]``, in the promoted dtype (bf16 content of the bf16 encoder
    against an fp32 dictionary: fp32, as JAX's einsum promotes)."""
    source = source.to(torch.promote_types(source.dtype, reference.dtype))
    ref_t = reference.transpose(-1, -2)
    if metric == "IP":
        return torch.matmul(source, ref_t)
    if metric == "L2":
        s2 = torch.sum(source * source, dim=-1, keepdim=True)
        r2 = torch.sum(reference * reference, dim=-1)[..., None, :]
        d2 = (s2 - 2.0 * torch.matmul(source, ref_t) + r2).clamp_min(0.0)
        return -torch.sqrt(d2)
    if metric == "cos":
        sn = source / (torch.linalg.vector_norm(source, dim=-1, keepdim=True) + 1e-6)
        rn = reference / (torch.linalg.vector_norm(reference, dim=-1, keepdim=True) + 1e-6)
        return torch.matmul(sn, rn.transpose(-1, -2))
    raise ValueError(f"unknown metric {metric!r}")


def top_k_small(x: torch.Tensor, k: int):
    """Top-k over the last axis by k argmax passes; ties go to the lowest
    index (``torch.argmax`` returns the first maximum; ``torch.topk``'s tie
    order is not specified). Returns (values, indices), each ``[..., k]``."""
    vals, idxs = [], []
    for _ in range(k):
        j = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, j))
        idxs.append(j)
        x = x.scatter(-1, j, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def match_features(
    source: torch.Tensor, reference: torch.Tensor, k: int = 4,
    alpha: float = 0.0, metric: str = "cos",
) -> torch.Tensor:
    """source ``[B, T, C]``, reference ``[N, C]`` or ``[B, N, C]`` ->
    matched ``[B, T, C]`` in the source's dtype (JAX's cast)."""
    _, idx = top_k_small(_similarities(source, reference, metric), k)  # [B, T, k]
    if reference.dim() == 2:
        neigh = reference[idx]  # [B, T, k, C]
    else:
        neigh = torch.stack([reference[b][idx[b]] for b in range(reference.shape[0])])
    result = neigh.mean(dim=2).to(source.dtype)
    if alpha == 0.0:
        return result
    return result * (1.0 - alpha) + source * alpha
