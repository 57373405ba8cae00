"""Carrying JAX parameter trees over to the port's modules.

Counterpart of `tinyvc_tpu/utils/model_store.py` (params-only ``.npz``
exports and ``.npy`` kNN indexes). The port's modules use the JAX tree's
names, so a flax path ``params/filter_net/up_0/c1/kernel`` becomes the
state-dict key ``filter_net.up_0.c1.weight``. Only layouts change, the
inverse of the transposes in `tinyvc_tpu/utils/torch_compat.py`:

- Dense kernel ``[in, out]``           -> weight ``[out, in]``
- depthwise conv kernel ``[K, 1, C]``  -> weight ``[C, 1, K]``
- full conv kernel ``[K, in, out]``    -> weight ``[out, in, K]``
- ``bias``, ``gamma``, ``beta``        -> unchanged
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import AudioConfig, DecoderConfig, EncoderConfig
from ..models.decoder import Decoder
from ..models.encoder import Encoder


def load_npz(path: str) -> Dict[str, Any]:
    """Rebuild the nested parameter tree from the flat ``params/...`` keys of
    a params-only ``.npz`` (as `model_store.py::_load_params_npz` does)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree


def load_index(path: str) -> np.ndarray:
    """A kNN dictionary ``[N, C]`` float32 from a ``.npy`` file."""
    if not path.endswith(".npy"):
        raise ValueError(f"expected a .npy kNN index, got {path!r}")
    arr = np.load(path)
    if arr.ndim != 2:
        raise ValueError(f"expected a [N, C] index, got shape {arr.shape}")
    return arr.astype(np.float32)


def state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree (with or without its ``params`` root)
    into a state dict of the port's layouts."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def rec(prefix: str, node: Mapping[str, Any]) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                rec(f"{prefix}{name}.", value)
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                name = "weight"
                arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
            out[prefix + name] = torch.tensor(arr)

    rec("", tree)
    return out


def encoder_from_jax(tree: Mapping[str, Any], cfg: EncoderConfig = EncoderConfig()) -> Encoder:
    """The port's :class:`Encoder` holding the weights of a JAX encoder tree
    (on the CPU, in eval mode)."""
    model = Encoder(cfg)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model.eval()


def decoder_from_jax(tree: Mapping[str, Any], cfg: DecoderConfig = DecoderConfig(),
                     audio: AudioConfig = AudioConfig()) -> Decoder:
    """The port's :class:`Decoder` holding the weights of a JAX decoder tree
    (on the CPU, in eval mode)."""
    model = Decoder(cfg, audio)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model.eval()
