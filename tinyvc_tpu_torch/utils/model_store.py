"""Loading model parameters and kNN indexes (counterpart of
`tinyvc_tpu/utils/model_store.py`).

Accepted: params-only ``.npz`` exports (``save_params_npz``, the JAX
package's ``cli/export_params``), the reference's ``.pt`` state dicts
(through `utils/torch_compat.py`), and kNN indexes as ``.npy`` ``[N, C]`` or
the reference's ``index.pt`` ``[1, C, N]``; and the checkpoint directories
the port's trainers write (`utils/checkpoint.py`: the newest step's
parameters). Each loader returns the JAX package's parameter tree of numpy
arrays, which `utils/weights.py` carries over to the port's modules. The
JAX package's orbax checkpoint directories need orbax and JAX and are not
read here (ROADMAP §1 item 2).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import TinyVCConfig
from .checkpoint import CheckpointManager, load_params
from .torch_compat import (decoder_params_from_torch, encoder_params_from_torch,
                           load_torch_checkpoint)
from .weights import load_npz


def save_params_npz(path: str, params: Dict[str, Any]) -> None:
    """Write a nested parameter tree as a compressed ``.npz`` with
    '/'-joined key paths (the params-only export format)."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + (str(k),), v)
        else:
            flat["/".join(prefix)] = np.asarray(node)

    rec((), params)
    np.savez_compressed(path, **flat)


def _port_checkpoint(path: str) -> bool:
    """Whether ``path`` is a directory of the port's ``<step>/state.pt``
    checkpoints."""
    return os.path.isdir(path) and CheckpointManager(path, create=False).latest_step() is not None


def _unsupported(path: str, what: str) -> Exception:
    if os.path.isdir(path):
        return ValueError(
            f"{path!r} is a directory without the port's <step>/state.pt checkpoints: "
            "orbax checkpoint directories need orbax and JAX, "
            f"which this package does not import (ROADMAP §1 item 2); export the {what} "
            "to a params-only .npz with the JAX package's cli/export_params")
    if not os.path.exists(path):
        return FileNotFoundError(f"no {what} checkpoint at {path!r}")
    return ValueError(f"unsupported {what} checkpoint {path!r}: expected .npz or .pt")


def load_encoder_params(path: str, cfg: Optional[TinyVCConfig] = None) -> Dict[str, Any]:
    """An encoder's parameter tree from ``.npz``, a reference ``.pt`` or a
    checkpoint directory of the port's encoder training."""
    cfg = cfg or TinyVCConfig()
    if _port_checkpoint(path):
        return load_params(path, "params/")
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".pt"):
        e = cfg.encoder
        return {"params": encoder_params_from_torch(load_torch_checkpoint(path),
                                                    e.pitch_num_layers, len(e.ssl_dilations))}
    raise _unsupported(path, "encoder")


def load_decoder_params(path: str, cfg: Optional[TinyVCConfig] = None) -> Dict[str, Any]:
    """A decoder's parameter tree from ``.npz``, a reference ``.pt`` or a
    checkpoint directory of the port's decoder training."""
    cfg = cfg or TinyVCConfig()
    if _port_checkpoint(path):
        return load_params(path, "gen_params/params/")
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".pt"):
        d = cfg.decoder
        return {"params": decoder_params_from_torch(load_torch_checkpoint(path),
                                                    d.source_num_layers, len(d.filter_factors))}
    raise _unsupported(path, "decoder")


def load_index(path: str) -> np.ndarray:
    """A kNN dictionary ``[N, C]`` float32: our ``.npy``, or the reference's
    ``index.pt`` ``[1, C, N]``."""
    if path.endswith(".pt"):
        arr = torch.load(path, map_location="cpu", weights_only=True).detach().cpu().numpy()
        if arr.ndim == 3:  # [1, C, N] -> [N, C]
            arr = arr[0].T
        return arr.astype(np.float32)
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim != 2:
            raise ValueError(f"expected a [N, C] index, got shape {arr.shape}")
        return arr.astype(np.float32)
    raise _unsupported(path, "kNN index")
