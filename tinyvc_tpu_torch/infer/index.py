"""kNN dictionary (speaker index) extraction (counterpart of
`tinyvc_tpu/infer/index.py`).

Encode the dataset cache with the frozen encoder, keep every
``stride``-th frame, stop once more than ``size`` vectors are gathered,
shuffle along time and keep ``size``: a ``[N, C]`` float32 array, the
``.npy`` the conversion CLIs read with ``-idx``. The batches, their order
and the shuffle are the JAX package's for the same seed.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..config import TinyVCConfig
from ..data.dataset import DataLoader, Dataset
from .generator import VoiceConverter


def extract_index(
    enc_params: Mapping[str, Any],
    dataset_dir: str = "dataset_cache",
    size: int = 2048,
    stride: int = 4,
    seed: int = 0,
    cfg: TinyVCConfig | None = None,
    batch_size: int = 16,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Returns the dictionary ``[min(size, N), ssl_dim]``. The encoder runs
    on ``device`` (CUDA by default, which raises without it)."""
    cfg = cfg or TinyVCConfig()
    vc = VoiceConverter(enc_params, None, cfg, device=device)
    ds = Dataset(dataset_dir)
    # the loader drops the ragged tail; a dataset smaller than one batch
    # still contributes, in one batch
    dl = DataLoader(ds, batch_size=max(1, min(batch_size, len(ds))), seed=seed)

    feats = []
    total = 0
    for batch in dl:
        content, _ = vc.encode(batch["wave"])
        z = content[:, ::stride, :].cpu().numpy()  # [B, F/stride, C]
        z = z.reshape(-1, z.shape[-1])
        feats.append(z)
        total += z.shape[0]
        if total > size:
            break
    if not feats:
        raise RuntimeError("empty dataset")
    all_feats = np.concatenate(feats, axis=0)
    np.random.default_rng(seed).shuffle(all_feats, axis=0)
    return all_feats[:size].astype(np.float32)
