"""Train-state checkpoints with ``torch.save`` (counterpart of
`tinyvc_tpu/utils/checkpoint.py`, which writes orbax directories).

``<dir>/<step>/state.pt`` holds one flat dict under the JAX tree's names,
in the JAX layouts (a kernel as flax stores it): ``gen_params/params/...``,
AdamW's moments ``gen_opt/mu/params/...`` and ``gen_opt/nu/params/...``,
``gen_opt/count``, ``gen_opt/notfinite_count``, the discriminator's
``disc_params/params/...`` and ``disc_opt/{mu,nu,count,notfinite_count}``
alike, and ``step``; beside it ``config.json``. A save writes a temporary
directory and renames it, and the newest ``max_to_keep`` steps are kept.
Restoring the newest step resumes training where it stopped: parameters,
moments, counts. A checkpoint without ``disc_*`` entries (written before
the discriminator was ported) restores the generator and keeps the state's
freshly drawn discriminator.
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


def _net_to_tree(out: Dict[str, object], prefix: str, module, opt) -> None:
    for name, p in module.named_parameters():
        path = jax_name(name)
        out[f"{prefix}_params/{path}"] = to_jax_layout(p, name)
        out[f"{prefix}_opt/mu/{path}"] = to_jax_layout(opt.mu[name], name)
        out[f"{prefix}_opt/nu/{path}"] = to_jax_layout(opt.nu[name], name)
    out[f"{prefix}_opt/count"] = int(opt.count)
    out[f"{prefix}_opt/notfinite_count"] = int(opt.notfinite_count)


def _net_from_tree(tree: Dict[str, object], prefix: str, module, opt) -> None:
    with torch.no_grad():
        for name, p in module.named_parameters():
            path = jax_name(name)
            p.copy_(from_jax_layout(tree[f"{prefix}_params/{path}"], name))
            opt.mu[name] = from_jax_layout(tree[f"{prefix}_opt/mu/{path}"], name).to(p.device)
            opt.nu[name] = from_jax_layout(tree[f"{prefix}_opt/nu/{path}"], name).to(p.device)
    opt.count = int(tree[f"{prefix}_opt/count"])
    opt.notfinite_count = int(tree[f"{prefix}_opt/notfinite_count"])


def state_to_tree(state: TrainState) -> Dict[str, object]:
    """``state`` as the flat dict a checkpoint holds."""
    out: Dict[str, object] = {}
    _net_to_tree(out, "gen", state.decoder, state.gen_opt)
    if state.discriminator is not None:
        _net_to_tree(out, "disc", state.discriminator, state.disc_opt)
    out["step"] = int(state.step)
    return out


def load_tree_into(state: TrainState, tree: Dict[str, object]) -> bool:
    """Write a checkpoint's dict into ``state`` (same architecture); False
    when the checkpoint holds no discriminator for the state's (which then
    stays as it is)."""
    _net_from_tree(tree, "gen", state.decoder, state.gen_opt)
    state.step = int(tree["step"])
    if state.discriminator is None:
        return True
    if "disc_opt/count" not in tree:
        return False
    _net_from_tree(tree, "disc", state.discriminator, state.disc_opt)
    return True


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
        if not load_tree_into(state, tree):
            print(f"checkpoint step {step} holds no discriminator: restored the generator, "
                  "keeping the freshly drawn discriminator")
        return state
