"""One rank of a `tinyvc_tpu_torch` process group on the CPU (gloo), for the
distributed tests: ``python tests/torch_dist_worker.py DIR RANK WORLD PORT``.

``DIR/cases.json`` lists the cases ``[{"name", "kind", "args"}, ...]``;
``DIR/<name>.npz`` holds a case's inputs (parameter trees under ``enc/`` and
``dec/`` as flat '/'-joined keys). The rank joins the group, runs every case
in order and writes ``DIR/<name>.<rank>.npz``. A case of kind ``cli`` runs a
training CLI instead, which joins the group itself through its flags. The
worker imports only the port: JAX, flax and `tinyvc_tpu` are refused on
import, as `tests/test_torch_isolation.py` refuses them in the package.
"""

import importlib.abc
import json
import math
import os
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "tinyvc_tpu")


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None


sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tinyvc_tpu_torch import config as pcfg  # noqa: E402
from tinyvc_tpu_torch.infer.generator import convert_fn_sharded, exact_fp32  # noqa: E402
from tinyvc_tpu_torch.infer.stream import StreamConverter  # noqa: E402
from tinyvc_tpu_torch.parallel.mesh import (init_distributed, make_mesh,  # noqa: E402
                                            shard_batch)
from tinyvc_tpu_torch.parallel.sharded_knn import (dictionary_shard,  # noqa: E402
                                                   pad_dictionary, sharded_match_features)
from tinyvc_tpu_torch.parallel.time_shard import time_sharded_convert  # noqa: E402
from tinyvc_tpu_torch.train import decoder_train, encoder_train  # noqa: E402
from tinyvc_tpu_torch.train.decoder_train import OptState  # noqa: E402
from tinyvc_tpu_torch.utils import prng  # noqa: E402
from tinyvc_tpu_torch.utils.checkpoint import (CheckpointManager,  # noqa: E402
                                               replicate_state, state_to_tree)
from tinyvc_tpu_torch.utils.weights import (decoder_from_jax, encoder_from_jax,  # noqa: E402
                                            nest)

TIMEOUT_S = 120  # a rank that has not joined or answered by then fails the group


def _config(args):
    kw = {}
    for name, cls in (("encoder", pcfg.EncoderConfig), ("decoder", pcfg.DecoderConfig),
                      ("discriminator", pcfg.DiscriminatorConfig),
                      ("stream", pcfg.StreamConfig), ("train", pcfg.TrainConfig)):
        if name in args:
            kw[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in args[name].items()})
    return pcfg.TinyVCConfig(**kw)


def _tree(inputs, prefix):
    return nest({k[len(prefix):]: inputs[k] for k in inputs if k.startswith(prefix)})


def _modules(inputs, cfg):
    return (encoder_from_jax(_tree(inputs, "enc/"), cfg.encoder),
            decoder_from_jax(_tree(inputs, "dec/"), cfg.decoder, cfg.audio))


def case_knn(args, x):
    mesh = make_mesh(*args["mesh"])
    padded, mask = pad_dictionary(torch.from_numpy(x["dictionary"]), mesh.model, args["k"])
    shard, mshard = dictionary_shard(padded, mask, mesh)
    src = shard_batch(torch.from_numpy(x["source"]), mesh)
    with torch.inference_mode(), exact_fp32():
        out = sharded_match_features(mesh, src, shard, mshard, k=args["k"],
                                     alpha=args.get("alpha", 0.0), metric=args["metric"],
                                     payload=args["payload"])
    return {"out": out.numpy()}


def case_convert(args, x):
    mesh = make_mesh(*args["mesh"])
    cfg = _config(args)
    enc, dec = _modules(x, cfg)
    padded, mask = pad_dictionary(torch.from_numpy(x["dictionary"]), mesh.model,
                                  cfg.retrieval.k)
    with torch.inference_mode(), exact_fp32():
        out = convert_fn_sharded(enc, dec, shard_batch(torch.from_numpy(x["wave"]), mesh),
                                 *dictionary_shard(padded, mask, mesh), args["pitch"], 0, cfg,
                                 mesh, noise_angle=shard_batch(torch.from_numpy(x["angle"]), mesh))
    return {"out": out.numpy()}


def case_stream(args, x):
    """The stream on a ``(1, model)`` mesh, each block's noise JAX's CPU
    draw from the block's subkey (`tests/test_torch_stream.py::_jax_noise`)."""
    mesh = make_mesh(*args["mesh"])
    cfg = _config(args)
    F = cfg.stream.input_size // cfg.audio.hop_size

    def noise(subkey):
        return 0, torch.from_numpy(prng.uniform(subkey, (1, F, cfg.audio.fft_bin), -math.pi,
                                                math.pi))

    sc = StreamConverter(_tree(x, "enc/"), _tree(x, "dec/"), x["target"], cfg,
                         pitch_shift=args["pitch"], key=prng.prng_key(args["seed"]), mesh=mesh,
                         device="cpu", noise=noise)
    outs, shifts = [], []
    block = cfg.stream.block_size
    for b in range(x["wave"].shape[0] // block):
        stats = {}
        outs.append(sc.step(x["wave"][b * block:(b + 1) * block], stats).numpy())
        shifts.append(int(stats["shift"]))
    return {"out": np.stack(outs), "shifts": np.array(shifts)}


def case_time_shard(args, x):
    mesh = make_mesh(*args["mesh"])
    cfg = _config(args)
    enc, dec = _modules(x, cfg)
    angle = torch.from_numpy(x["angle"]) if "angle" in x else None
    with torch.inference_mode(), exact_fp32():
        out = time_sharded_convert(mesh, enc, dec, torch.from_numpy(x["wave"]),
                                   torch.from_numpy(x["target"]), args["pitch"],
                                   prng.prng_key(args["seed"]), cfg,
                                   halo_frames=args["halo"], filter_halo=args["filter_halo"],
                                   noise_angle=angle)
    return {"out": out.numpy()}


def _named(prefix, tensors):
    return {f"{prefix}{k}": v.detach().numpy() for k, v in tensors.items()}


def case_encoder_step(args, x):
    """This rank's rows of the global batch: the first step's loss and
    gradients, then ``steps`` steps' losses, parameters and moments."""
    mesh = make_mesh(*args["mesh"])
    cfg = _config(args)
    enc = encoder_from_jax(_tree(x, "enc/"), cfg.encoder).train()
    state = encoder_train.EncoderTrainState(enc, OptState.fresh(enc))
    step = encoder_train.make_train_step(cfg, args["distill"], mesh)
    batch = [shard_batch(torch.from_numpy(x[k]), mesh) for k in ("wave", "f0", "teacher")]
    key = prng.prng_key(args["seed"])
    loss, metrics, grads = step.loss_and_grads(state, *batch, key)
    out = {"loss": loss.numpy(), **_named("metric/", metrics), **_named("grad/", grads)}
    losses = [float(step(state, *batch, k)["loss"]) for k in prng.split(key, args["steps"])]
    out["losses"] = np.array(losses)
    out.update(_named("param/", dict(state.encoder.named_parameters())))
    out.update(_named("mu/", state.opt.mu))
    out.update(_named("nu/", state.opt.nu))
    return out


def _decoder_state(cfg, seed):
    enc = encoder_train.init_state(cfg, seed, "cpu").encoder.eval().requires_grad_(False)
    state = decoder_train.init_state(cfg, seed + 1, "cpu")
    return enc, decoder_train.TrainState.fresh(state.decoder)


def case_decoder_step(args, x):
    """This rank's rows: the pre-join step's loss and gradients, then
    ``steps`` steps and the parameters they leave."""
    mesh = make_mesh(*args["mesh"])
    cfg = _config(args)
    enc, state = _decoder_state(cfg, args["seed"])
    step = decoder_train.make_train_step(cfg, False, args["loss"], mesh=mesh)
    wave = shard_batch(torch.from_numpy(x["wave"]), mesh)
    key = prng.prng_key(args["seed"] + 2)
    loss, metrics, grads = step.loss_and_grads(state, enc, wave, key)
    out = {"loss": loss.numpy(), **_named("metric/", metrics), **_named("grad/", grads)}
    for k in prng.split(key, args["steps"]):
        step(state, enc, wave, k)
    out.update(_named("param/", dict(state.decoder.named_parameters())))
    return out


def case_restore(args, x):
    """A state drawn from another seed, restored from ``ckpt`` and made
    rank 0's: its tree."""
    cfg = _config(args)
    state = decoder_train.init_state(cfg, args["seed"], "cpu")
    CheckpointManager(args["ckpt"]).restore(state)
    replicate_state(state)
    tree = state_to_tree(state)
    return {k: np.asarray(v) for k, v in tree.items()}


def case_train(args, x):
    """`train/loop.py::train_decoder` (a random encoder and decoder from the
    seed) to ``steps``, resuming from ``ckpt``: the final state's tree."""
    from tinyvc_tpu_torch.train.loop import train_decoder

    cfg = _config(args)
    state = train_decoder(cfg, dataset_dir=args["cache"], ckpt_dir=args["ckpt"],
                          log_dir=args["logs"], max_steps=args["steps"], spec_loss_type="mel",
                          seed=args["seed"], device="cpu")
    return {k: np.asarray(v) for k, v in state_to_tree(state).items()}


CASES = {"knn": case_knn, "convert": case_convert, "stream": case_stream,
         "time_shard": case_time_shard, "encoder_step": case_encoder_step,
         "decoder_step": case_decoder_step, "restore": case_restore, "train": case_train}


def run_cli(case, rank, world, port):
    from tinyvc_tpu_torch.cli import train_decoder, train_encoder

    cli = {"train_decoder": train_decoder, "train_encoder": train_encoder}[case["args"]["cli"]]
    flags = [a.replace("{rank}", str(rank)) for a in case["args"]["flags"]]
    cli.main(flags + ["--device", "cpu", "--coordinator-address", f"localhost:{port}",
                      "--num-processes", str(world), "--process-id", str(rank)])


def main(directory, rank, world, port):
    torch.set_num_threads(2)
    with open(os.path.join(directory, "cases.json")) as f:
        cases = json.load(f)
    if any(c["kind"] == "cli" for c in cases):
        for case in cases:
            run_cli(case, rank, world, port)
        return
    init_distributed(f"localhost:{port}", world, rank, device="cpu", timeout_s=TIMEOUT_S)
    try:
        for case in cases:
            path = os.path.join(directory, f"{case['name']}.npz")
            inputs = dict(np.load(path)) if os.path.exists(path) else {}
            out = CASES[case["kind"]](case["args"], inputs)
            np.savez(os.path.join(directory, f"{case['name']}.{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    d, r, w, p = sys.argv[1:5]
    main(d, int(r), int(w), int(p))
