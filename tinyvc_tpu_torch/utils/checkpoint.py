"""Train-state checkpoints with ``torch.save`` (counterpart of
`tinyvc_tpu/utils/checkpoint.py`, which writes orbax directories).

``<dir>/<step>/state.pt`` holds one flat dict under the JAX tree's names,
in the JAX layouts (a kernel as flax stores it): ``gen_params/params/...``,
AdamW's moments ``gen_opt/mu/params/...`` and ``gen_opt/nu/params/...``,
``gen_opt/count``, ``gen_opt/notfinite_count``, the discriminator's
``disc_params/params/...`` and ``disc_opt/{mu,nu,count,notfinite_count}``
alike, and ``step``; beside it ``config.json``. An encoder's train state
(`train/encoder_train.py`) is ``params/...``, ``opt/mu/params/...``,
``opt/nu/params/...``, ``opt/count`` and ``step``, the names of JAX's
``EncoderTrainState``. A save writes a temporary
directory and renames it, and the newest ``max_to_keep`` steps are kept.
Restoring the newest step resumes training where it stopped: parameters,
moments, counts. A checkpoint without ``disc_*`` entries (written before
the discriminator was ported) restores the generator and keeps the state's
freshly drawn discriminator.

In a process group of more than one rank (data-parallel training, the
counterpart of JAX's collective save), rank 0 writes and then every rank
passes a barrier; a restore reads the step rank 0 finds newest on every
rank, and :func:`replicate_state` then makes every rank's state rank 0's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from ..parallel.mesh import broadcast_object, process_count, process_index, replicate
from ..train.decoder_train import TrainState
from ..train.encoder_train import EncoderTrainState
from .weights import from_jax_layout, jax_name, nest, to_jax_layout

# (parameters' prefix, optimizer's prefix, whether it counts skipped steps)
_GEN, _DISC, _ENC = ("gen_params/", "gen_opt", True), ("disc_params/", "disc_opt", True), \
    ("", "opt", False)


def _net_to_tree(out: Dict[str, object], keys, module, opt) -> None:
    params, prefix, skips = keys
    for name, p in module.named_parameters():
        path = jax_name(name)
        out[f"{params}{path}"] = to_jax_layout(p, name)
        out[f"{prefix}/mu/{path}"] = to_jax_layout(opt.mu[name], name)
        out[f"{prefix}/nu/{path}"] = to_jax_layout(opt.nu[name], name)
    out[f"{prefix}/count"] = int(opt.count)
    if skips:
        out[f"{prefix}/notfinite_count"] = int(opt.notfinite_count)


def _net_from_tree(tree: Dict[str, object], keys, module, opt) -> None:
    params, prefix, skips = keys
    with torch.no_grad():
        for name, p in module.named_parameters():
            path = jax_name(name)
            p.copy_(from_jax_layout(tree[f"{params}{path}"], name))
            opt.mu[name] = from_jax_layout(tree[f"{prefix}/mu/{path}"], name).to(p.device)
            opt.nu[name] = from_jax_layout(tree[f"{prefix}/nu/{path}"], name).to(p.device)
    opt.count = int(tree[f"{prefix}/count"])
    if skips:
        opt.notfinite_count = int(tree[f"{prefix}/notfinite_count"])


def state_to_tree(state: Union[TrainState, EncoderTrainState]) -> Dict[str, object]:
    """``state`` as the flat dict a checkpoint holds."""
    out: Dict[str, object] = {}
    if isinstance(state, EncoderTrainState):
        _net_to_tree(out, _ENC, state.encoder, state.opt)
    else:
        _net_to_tree(out, _GEN, state.decoder, state.gen_opt)
        if state.discriminator is not None:
            _net_to_tree(out, _DISC, state.discriminator, state.disc_opt)
    out["step"] = int(state.step)
    return out


def _nets(state: Union[TrainState, EncoderTrainState]):
    """(module, optimizer state) of each network the state trains."""
    if isinstance(state, EncoderTrainState):
        return [(state.encoder, state.opt)]
    nets = [(state.decoder, state.gen_opt)]
    if state.discriminator is not None:
        nets.append((state.discriminator, state.disc_opt))
    return nets


def replicate_state(state: Union[TrainState, EncoderTrainState]) -> None:
    """Rank 0's state on every rank, in place: the parameters and moments by
    bucketed broadcasts, the step and the optimizers' counts as one object."""
    tensors, counts = [], []
    for module, opt in _nets(state):
        for name, p in module.named_parameters():
            tensors += [p, opt.mu[name], opt.nu[name]]
        counts.append((opt.count, opt.notfinite_count))
    replicate(tensors)
    state.step, counts = broadcast_object((state.step, counts))
    for (_, opt), (count, skipped) in zip(_nets(state), counts):
        opt.count, opt.notfinite_count = count, skipped


def load_tree_into(state: Union[TrainState, EncoderTrainState],
                   tree: Dict[str, object]) -> bool:
    """Write a checkpoint's dict into ``state`` (same architecture); False
    when the checkpoint holds no discriminator for the state's (which then
    stays as it is)."""
    state.step = int(tree["step"])
    if isinstance(state, EncoderTrainState):
        _net_from_tree(tree, _ENC, state.encoder, state.opt)
        return True
    _net_from_tree(tree, _GEN, state.decoder, state.gen_opt)
    if state.discriminator is None:
        return True
    if "disc_opt/count" not in tree:
        return False
    _net_from_tree(tree, _DISC, state.discriminator, state.disc_opt)
    return True


def load_params(directory: str, prefix: str) -> Dict[str, object]:
    """The parameter tree ``{"params": {...}}`` (numpy, JAX layouts) of the
    newest checkpoint in ``directory``: the entries under ``prefix``
    (``"params/"`` an encoder's, ``"gen_params/params/"`` a decoder's)."""
    mgr = CheckpointManager(directory, create=False)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no <step>/state.pt checkpoint under {directory!r}")
    tree = torch.load(os.path.join(mgr.directory, str(step), "state.pt"), weights_only=False)
    params = {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix)}
    if not params:
        raise ValueError(f"checkpoint {directory!r} step {step} holds no {prefix!r} entries")
    return {"params": nest(params)}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, create: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if create:
            os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n, "state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Union[TrainState, EncoderTrainState], config=None) -> str:
        """Write ``<dir>/<step>/`` (by rank 0 alone in a group of more than
        one rank, then a barrier that every rank passes)."""
        final = os.path.join(self.directory, str(step))
        if process_index() == 0:
            self._write(final, state, config)
        if process_count() > 1:
            dist.barrier()
        return final

    def _write(self, final: str, state, config) -> None:
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

    def restore(self, state, step: Optional[int] = None):
        """Load ``step`` (default the newest, as rank 0 finds it) into
        ``state``; None when the directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if process_count() > 1:
            step = broadcast_object(step)
        if step is None:
            return None
        tree = torch.load(os.path.join(self.directory, str(step), "state.pt"), weights_only=False)
        if not load_tree_into(state, tree):
            print(f"checkpoint step {step} holds no discriminator: restored the generator, "
                  "keeping the freshly drawn discriminator")
        return state
