"""Kernel H: kNN feature matching against one shared dictionary
(`csrc/knn.cu`).

Replaces `tinyvc_tpu/ops/pallas/knn.py::pallas_match_features`: source
``[B, T, C]`` and one dictionary ``[N, C]`` -> matched ``[B, T, C]`` fp32.
Each frame is ranked against every dictionary row (cos: both normalised
with ``+1e-6``; IP: ``s.r``; L2: ``2 s.r - |r|^2``), its k best are taken by
k argmax passes (ties to the lowest index), and it becomes the mean of
those rows rounded to bf16 (the TPU kernel's ``ref_mean``), blended with the
source by ``alpha``. The bf16-rounded mean is what sets this function apart
from `ops/retrieval.py::match_features`; `infer/generator.py` picks one by
the JAX package's gate. The similarities are fp32 sums (the TPU's default
is a bf16x3 split, ~1.5e-5 relative).

CPU tensors take the plain version; CUDA tensors launch kernel H (three
launches: the source transposed and normalised, similarities with
per-slice top-k on the :func:`knn_schedule` tiles, then the merge, mean
and blend).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.retrieval import top_k_small
from . import build

METRICS = {"cos": 0, "IP": 1, "L2": 2}
K_MAX = 8
# csrc/knn.cu: dictionary rows a tile, the transposed copies' column
# padding, blocks that fill the H100's 132 SMs twice, candidate lists a row
TILE, PAD, FILL, MAX_SPLIT = 64, 64, 2 * 132, 32


def knn_schedule(R: int, N: int) -> Tuple[int, int, int]:
    """Kernel H's similarity tiles for ``R`` source rows and ``N``
    dictionary rows, as `csrc/knn.cu::schedule` chooses them: (source rows a
    block, dictionary rows a slice, slices). Blocks of 64 rows (4 warps)
    when they alone give ``FILL`` blocks, else of 32 (2 warps of rows, each
    tile's channels split between two); slices of one 64-row tile, or of as
    many as keep ``MAX_SPLIT`` slices. Block
    ``(i, s)`` ranks rows ``[i*rows, (i+1)*rows)`` against dictionary rows
    ``[s*slice, min(N, (s+1)*slice))`` and writes their k best to slot
    ``s`` of the ``[slices, R, k]`` candidate workspace."""
    nt = -(-N // TILE)
    per = -(-nt // MAX_SPLIT)
    nsplit = -(-nt // per)
    rows = 64 if -(-R // 64) * nsplit >= FILL else 32
    return rows, per * TILE, nsplit


def _padded(n: int) -> int:
    return -(-n // PAD) * PAD


def _dictionary(reference: torch.Tensor, metric: str):
    """(similarity rows, rank-bias row, bf16 mean rows) of the dictionary,
    as the JAX wrapper prepares them outside its kernel."""
    ref = reference.float()
    if metric == "cos":
        ref_sim = ref / (torch.sqrt(torch.sum(ref * ref, dim=1, keepdim=True)) + 1e-6)
    else:
        ref_sim = ref
    row = -torch.sum(ref * ref, dim=1) if metric == "L2" else torch.zeros_like(ref[:, 0])
    return ref_sim.contiguous(), row.contiguous(), ref.to(torch.bfloat16).contiguous()


def _kernel_dictionary(reference: torch.Tensor, metric: str):
    """:func:`_dictionary` in kernel H's layout: the similarity rows
    transposed, ``[C, N]`` padded with zero columns to a multiple of
    ``PAD`` (both operands of its product are channel-major), the rank-bias
    row, the bf16 mean rows."""
    ref_sim, row, ref_mean = _dictionary(reference, metric)
    N, C = ref_sim.shape
    ref_t = ref_sim.new_zeros((C, _padded(N)))
    ref_t[:, :N] = ref_sim.T
    return ref_t, row, ref_mean


def prepared_dictionary(reference: torch.Tensor, metric: str):
    """:func:`_kernel_dictionary` of ``reference``, kept on the tensor after the
    first call: a converter matches every request against the same
    dictionary. Prepared again only when the metric, the data pointer or the
    version counter changed (an in-place write; inference tensors keep no
    version counter, as in `ops/fused_filternet.py::fused_weights`)."""
    key = (metric, reference.data_ptr(), 0 if reference.is_inference() else reference._version)
    cached = getattr(reference, "_knn_cache", None)
    if cached is None or cached[0] != key:
        cached = (key, _kernel_dictionary(reference, metric))
        reference._knn_cache = cached
    return cached[1]


def _mean(ref_mean: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The fp32 mean of the bf16 rows ``idx [..., k]``, summed in
    increasing index order."""
    order = torch.sort(idx, dim=-1).values
    total = torch.zeros(idx.shape[:-1] + ref_mean.shape[1:], dtype=torch.float32,
                        device=ref_mean.device)
    for j in range(idx.shape[-1]):
        total = total + ref_mean[order[..., j]].float()
    return total / idx.shape[-1]


def _blend(mean: torch.Tensor, x: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 0.0:
        return mean
    return mean * float(np.float32(1.0 - alpha)) + x * float(np.float32(alpha))


def _check_args(source: torch.Tensor, reference: torch.Tensor, k: int, metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if reference.dim() != 2 or source.dim() != 3 or source.shape[-1] != reference.shape[-1]:
        raise ValueError(f"need source [B, T, C] and one dictionary [N, C], got "
                         f"{tuple(source.shape)} and {tuple(reference.shape)}")
    if not 1 <= k <= min(K_MAX, reference.shape[0]):
        raise ValueError(f"k must be in [1, min({K_MAX}, N={reference.shape[0]})], got {k}")


def match_features_knn_plain(
    source: torch.Tensor, reference: torch.Tensor, k: int = 4, alpha: float = 0.0,
    metric: str = "cos", return_indices: bool = False,
):
    """Plain PyTorch version: one fp32 similarity matmul, k argmax passes,
    the bf16-row mean and the blend. With ``return_indices``, also the
    neighbours ``[B, T, k]`` (int64), best first."""
    _check_args(source, reference, k, metric)
    x = source.float()
    ref_sim, row, ref_mean = _dictionary(reference, metric)
    xn = x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + 1e-6) if metric == "cos" else x
    sims = torch.matmul(xn, ref_sim.T)
    if metric == "L2":
        sims = 2.0 * sims + row
    _, idx = top_k_small(sims, k)
    out = _blend(_mean(ref_mean, idx), x, alpha)
    return (out, idx) if return_indices else out


def match_features_knn(
    source: torch.Tensor, reference: torch.Tensor, k: int = 4, alpha: float = 0.0,
    metric: str = "cos", return_indices: bool = False,
):
    """source ``[B, T, C]`` fp32, reference ``[N, C]`` -> matched
    ``[B, T, C]`` fp32 (and, with ``return_indices``, the neighbours
    ``[B, T, k]``, best first). CPU tensors take the plain version; CUDA
    tensors launch kernel H. A bf16 ``source`` (the bf16 encoder's content)
    is matched in fp32 and the result cast back, as JAX casts its kernel's."""
    if source.dtype != torch.float32:
        res = match_features_knn(source.float(), reference, k, alpha, metric, return_indices)
        return (res[0].to(source.dtype), res[1]) if return_indices else res.to(source.dtype)
    if build.on_cpu(source, reference):
        return match_features_knn_plain(source, reference, k, alpha, metric, return_indices)
    _check_args(source, reference, k, metric)
    build.check_input("source", source, 3)
    build.check_input("reference", reference, 2)
    B, T, C = source.shape
    N = reference.shape[0]
    ref_t, row, ref_mean = prepared_dictionary(reference, metric)
    R = B * T
    nsplit = knn_schedule(R, N)[2]
    dev = source.device
    x_t = torch.empty((C, _padded(R)), device=dev, dtype=torch.float32)
    cand_v = torch.empty((nsplit, R, k), device=dev, dtype=torch.float32)
    cand_i = torch.empty((nsplit, R, k), device=dev, dtype=torch.int32)
    out = torch.empty((B, T, C), device=dev, dtype=torch.float32)
    idx = torch.empty((B, T, k), device=dev, dtype=torch.int32)
    build.launch("tvc_knn", source, source, x_t, ref_t, row, ref_mean, cand_v, cand_i, out, idx,
                 R, N, C, k, METRICS[metric], nsplit, float(np.float32(alpha)),
                 float(np.float32(1.0 - alpha)))
    match_features_knn.launches += 1
    return (out, idx.long()) if return_indices else out


match_features_knn.launches = 0
