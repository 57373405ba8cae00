"""Train-state checkpoints with ``torch.save`` (counterpart of
`tinyvc_tpu/utils/checkpoint.py`, which writes orbax directories).

``<dir>/<step>/state.pt`` holds one flat dict under the JAX tree's names,
in the JAX layouts (a kernel as flax stores it): ``gen_params/params/...``,
AdamW's moments ``gen_opt/mu/params/...`` and ``gen_opt/nu/params/...``,
``gen_opt/count``, ``gen_opt/notfinite_count`` and ``step``; beside it
``config.json``. A save writes a temporary directory and renames it, and
the newest ``max_to_keep`` steps are kept. Restoring the newest step
resumes training where it stopped: parameters, moments, counts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Optional

import torch

from ..train.decoder_train import TrainState
from .weights import from_jax_layout, jax_name, to_jax_layout


def state_to_tree(state: TrainState) -> Dict[str, object]:
    """``state`` as the flat dict a checkpoint holds."""
    out: Dict[str, object] = {}
    for name, p in state.decoder.named_parameters():
        path = jax_name(name)
        out[f"gen_params/{path}"] = to_jax_layout(p, name)
        out[f"gen_opt/mu/{path}"] = to_jax_layout(state.mu[name], name)
        out[f"gen_opt/nu/{path}"] = to_jax_layout(state.nu[name], name)
    out["gen_opt/count"] = int(state.count)
    out["gen_opt/notfinite_count"] = int(state.notfinite_count)
    out["step"] = int(state.step)
    return out


def load_tree_into(state: TrainState, tree: Dict[str, object]) -> None:
    """Write a checkpoint's dict into ``state`` (same architecture)."""
    with torch.no_grad():
        for name, p in state.decoder.named_parameters():
            path = jax_name(name)
            p.copy_(from_jax_layout(tree[f"gen_params/{path}"], name))
            state.mu[name] = from_jax_layout(tree[f"gen_opt/mu/{path}"], name).to(p.device)
            state.nu[name] = from_jax_layout(tree[f"gen_opt/nu/{path}"], name).to(p.device)
    state.count = int(tree["gen_opt/count"])
    state.notfinite_count = int(tree["gen_opt/notfinite_count"])
    state.step = int(tree["step"])


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n, "state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, config=None) -> str:
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state_to_tree(state), os.path.join(tmp, "state.pt"))
        if config is not None:
            with open(os.path.join(tmp, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(config), f, indent=2)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return final

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Load ``step`` (default the newest) into ``state``; None when the
        directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        tree = torch.load(os.path.join(self.directory, str(step), "state.pt"), weights_only=False)
        load_tree_into(state, tree)
        return state
