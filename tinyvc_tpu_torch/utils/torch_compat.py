"""Reference ``.pt`` checkpoints as JAX parameter trees (counterpart of
`tinyvc_tpu/utils/torch_compat.py`).

Users of the reference hold ``models/encoder.pt`` and ``models/decoder.pt``
state dicts. These functions turn them into the JAX package's tree of
numpy arrays (flax names, channels-last layouts), which
`utils/weights.py::encoder_from_jax` and ``decoder_from_jax`` take, so one
loader serves ``.npz`` exports and ``.pt`` checkpoints alike. Only layouts
change:

- a 1x1 ``Conv1d`` weight ``[out, in, 1]``  -> Dense kernel ``[in, out]``
- a depthwise ``Conv1d`` ``[C, 1, K]``      -> ``[K, 1, C]``
- a full ``Conv1d`` ``[out, in, K]``        -> ``[K, in, out]``
- GRN's ``[1, C, 1]``                       -> ``[C]``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _dense(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    w = _np(sd[f"{prefix}.weight"])  # [out, in, 1]
    return {"kernel": w[:, :, 0].T.copy(), "bias": _np(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """A depthwise ``[C, 1, K]`` or full ``[out, in, K]`` conv -> ``[K, in, out]``."""
    w = _np(sd[f"{prefix}.weight"])
    return {"kernel": np.transpose(w, (2, 1, 0)).copy(), "bias": _np(sd[f"{prefix}.bias"])}


def _layernorm(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"gamma": _np(sd[f"{prefix}.gamma"]), "beta": _np(sd[f"{prefix}.beta"])}


def _grn(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"gamma": _np(sd[f"{prefix}.gamma"]).reshape(-1),
            "beta": _np(sd[f"{prefix}.beta"]).reshape(-1)}


def _convnext_layer(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        "dw": _conv(sd, f"{prefix}.c1"),
        "norm": _layernorm(sd, f"{prefix}.norm"),
        "pw1": _dense(sd, f"{prefix}.c2"),
        "grn": _grn(sd, f"{prefix}.grn"),
        "pw2": _dense(sd, f"{prefix}.c3"),
    }


def _convnext_stack(sd: Mapping[str, Any], prefix: str, num_layers: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "input_layer": _dense(sd, f"{prefix}.input_layer"),
        "norm": _layernorm(sd, f"{prefix}.norm"),
        "output_layer": _dense(sd, f"{prefix}.output_layer"),
    }
    for i in range(num_layers):
        out[f"layer_{i}"] = _convnext_layer(sd, f"{prefix}.mid_layers.{i}")
    return out


def encoder_params_from_torch(sd: Mapping[str, Any], num_pitch_layers: int = 4,
                              num_ssl_layers: int = 6) -> Dict[str, Any]:
    """The reference encoder's state dict -> the JAX tree (without its
    ``params`` root)."""
    return {
        "ssl_feature_estimator": {
            "stack": _convnext_stack(sd, "ssl_feature_estimator", num_ssl_layers)},
        "pitch_estimator": {"stack": _convnext_stack(sd, "pitch_estimator", num_pitch_layers)},
    }


def _film(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {"to_scale": _dense(sd, f"{prefix}.to_scale"),
            "to_shift": _dense(sd, f"{prefix}.to_shift")}


def _downsample(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        "down_res": _dense(sd, f"{prefix}.down_res"),
        "c1": _conv(sd, f"{prefix}.c1"),
        "c2": _conv(sd, f"{prefix}.c2"),
        "c3": _conv(sd, f"{prefix}.c3"),
    }


def _upsample(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        "c1": _conv(sd, f"{prefix}.c1"),
        "c2": _conv(sd, f"{prefix}.c2"),
        "c3": _conv(sd, f"{prefix}.c3"),
        "c4": _conv(sd, f"{prefix}.c4"),
        "c5": _dense(sd, f"{prefix}.c5"),
        "film1": _film(sd, f"{prefix}.film1"),
        "film2": _film(sd, f"{prefix}.film2"),
    }


def decoder_params_from_torch(sd: Mapping[str, Any], num_source_layers: int = 3,
                              num_stages: int = 5) -> Dict[str, Any]:
    """The reference decoder's state dict -> the JAX tree (without its
    ``params`` root)."""
    source: Dict[str, Any] = {
        "content_in": _dense(sd, "source_net.content_in"),
        "energy_in": _dense(sd, "source_net.energy_in"),
        "f0_in": _dense(sd, "source_net.f0_in"),
        "to_amps": _dense(sd, "source_net.to_amps"),
        "to_kernel": _dense(sd, "source_net.to_kernel"),
    }
    for i in range(num_source_layers):
        source[f"layer_{i}"] = _convnext_layer(sd, f"source_net.mid_layers.{i}")
    filt: Dict[str, Any] = {
        "content_in": _dense(sd, "filter_net.content_in"),
        "f0_in": _dense(sd, "filter_net.f0_in"),
        "down_0": _conv(sd, "filter_net.downs.0"),
        "output_layer": _conv(sd, "filter_net.output_layer"),
    }
    for i in range(1, num_stages):
        filt[f"down_{i}"] = _downsample(sd, f"filter_net.downs.{i}")
    for i in range(num_stages):
        filt[f"up_{i}"] = _upsample(sd, f"filter_net.ups.{i}")
    return {"source_net": source, "filter_net": filt}


def load_torch_checkpoint(path: str) -> Mapping[str, Any]:
    """A reference ``.pt`` state dict, read on the CPU; ``weights_only``
    refuses pickled code."""
    return torch.load(path, map_location="cpu", weights_only=True)
