"""The reference's discriminator checkpoints -> the port's discriminator
(counterpart of `tinyvc_tpu/utils/torch_compat_disc.py`).

The reference wraps every discriminator conv in ``weight_norm``; its state
dict stores ``parametrizations.weight.original0`` (g, ``[out, 1, 1, 1]``)
and ``original1`` (v, ``[out, in, kh, kw]``). The port's weight-normalised
convs keep v (HWIO) and g as flax does (`models/discriminator.py`), so the
import is a transpose and a reshape into the JAX tree, which
`utils/weights.py::discriminator_from_jax` carries over.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from ..config import DiscriminatorConfig
from .torch_compat import _np
from .weights import discriminator_from_jax


def _wn_conv2d(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    g = _np(sd[f"{prefix}.parametrizations.weight.original0"]).reshape(-1)
    v = _np(sd[f"{prefix}.parametrizations.weight.original1"])  # [out, in, kh, kw]
    return {"v": np.transpose(v, (2, 3, 1, 0)).copy(), "g": g, "bias": _np(sd[f"{prefix}.bias"])}


def discriminator_params_from_torch(sd: Mapping[str, Any], periods=(1, 2, 3, 5, 7, 11),
                                    resolutions=(32, 64, 128, 256),
                                    num_layers: int = 4) -> Dict[str, Any]:
    """A reference ``Discriminator`` state dict -> the JAX parameter tree
    ``mpd_{p}/conv_{i}|post/{v,g,bias}``, ``mrd_{r}/...`` (numpy)."""
    out: Dict[str, Any] = {}
    for kind, names, key in (("MPD", periods, "mpd"), ("MRD", resolutions, "mrd")):
        for i, name in enumerate(names):
            sub = {f"conv_{j}": _wn_conv2d(sd, f"{kind}.sub_discs.{i}.convs.{j}")
                   for j in range(num_layers + 1)}
            sub["post"] = _wn_conv2d(sd, f"{kind}.sub_discs.{i}.post")
            out[f"{key}_{name}"] = sub
    return out


def discriminator_from_torch(sd: Mapping[str, Any],
                             cfg: DiscriminatorConfig = DiscriminatorConfig()):
    """The port's ``Discriminator`` (on the CPU, in train mode) holding a
    reference state dict's weights."""
    tree = discriminator_params_from_torch(sd, cfg.periods, cfg.resolutions, cfg.num_layers)
    return discriminator_from_jax({"params": tree}, cfg)
