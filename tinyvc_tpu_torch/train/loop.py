"""The training loops of the encoder and the decoder on one device
(counterpart of `tinyvc_tpu/train/loop.py::train_encoder`, `::train_decoder`,
`::_make_loader` and `::_device_data_loader`).

Batches come from the native prefetch loader (`data/native_loader.py`)
unless ``TINYVC_NO_NATIVE_LOADER`` is set or the library does not build,
else from the Python loader in the JAX package's order (`data/dataset.py`);
the loop prints which. With ``device_data`` the whole cache is uploaded to
the device once and every batch is a row gather there, drawn by
``np.random.default_rng(seed)``; with ``steps_per_dispatch`` K > 1 on top
(0: the log interval), K steps run per window (`train/multi_step.py`),
where K divides every log, save and join boundary (``effective_k``; a K
that degrades to 1 is printed, and the loop steps one at a time).

The encoder's loop (``train_encoder``) starts from ``init_state(seed)``, or
from the newest checkpoint in ``ckpt_dir``, and runs ``epochs`` passes of
``len(cache) // B`` steps; its key is ``PRNGKey(seed + 1)``, split once a
step. The teacher's features come from the clean wave: a cache with
``{i}.teacher.npy`` gives a `train/teacher.py::CachedTeacher`, which needs
the Python loader's indices; without a teacher the step drops the
distillation term. Noise (``noises_dir``) is mixed in after the teacher.

The decoder's loop (``train_decoder``): the frozen encoder from
``encoder_path`` (an ``.npz``, a reference ``.pt`` or a checkpoint
directory of the port's encoder training, its newest step); the decoder
from the newest checkpoint in ``ckpt_dir`` (resuming its moments and
counts), else from ``init_decoder`` (an ``.npz``) or a random init drawn
from ``seed + 1``. The step keys are ``PRNGKey(seed + 2)``, split once per
step (once per window, into K + 1, with K steps). From
``cfg.train.discriminator_join`` on, each step is the post-join one: it
also logs the adversarial and feature-matching losses and prints ``d=``.
The discriminator is drawn from ``seed + 1`` after the decoder
(`train/decoder_train.py::init_state`) unless the checkpoint holds one.

Losses are logged every ``log_interval`` steps and the state saved every
``save_interval`` steps and at the end.

Data-parallel (`parallel/mesh.py`, one process per card): when the process
group (`init_distributed`) holds more than one process, both loops run on a
``(data=world, model=1)`` mesh, and the global batch must divide the world
(else JAX's message). Each rank's loader draws its ``local_batch_size``
rows with seed ``seed + 7919 * rank`` (the native loader, the Python
loader and the device-resident cache alike); each step averages its
gradients over the ranks; the state is broadcast from rank 0 after init
and after a restore; checkpoints are written by rank 0 (`utils/
checkpoint.py`); only rank 0 logs. K-step windows run only without a mesh.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import TinyVCConfig
from ..data.dataset import DataLoader, Dataset
from ..data.noise import NoiseGenerator
from ..dsp.resample import resample
from ..infer.generator import _resolve_device
from ..models.encoder import Encoder
from ..parallel.mesh import local_batch_size, make_mesh, process_count, process_index, replicate
from ..utils import prng
from ..utils.checkpoint import CheckpointManager, replicate_state
from ..utils.metrics import (TAG_D_ADV, TAG_DISTILL, TAG_DSP, TAG_FEAT, TAG_G_ADV, TAG_PITCH,
                             TAG_SKIPPED, TAG_SPEC, MetricsWriter)
from ..utils.model_store import load_encoder_params
from ..utils.weights import encoder_from_jax, load_npz, train_state_from_jax
from . import decoder_train, encoder_train
from .multi_step import effective_k, make_decoder_multi_step, make_encoder_multi_step
from .teacher import CachedTeacher, WavLMTeacher, make_teacher

MULTI_STEP_SEED = 4242  # the K-step windows' index draws: default_rng(seed + 4242)
RANK_SEED = 7919  # rank r's loader draws from seed + 7919 * r


def _mesh_or_none(batch_size: int):
    """A ``(data=world, model=1)`` mesh when the process group holds more
    than one process (the global batch must divide it), else None."""
    n = process_count()
    if n == 1:
        return None
    if batch_size % n:
        raise ValueError(f"multi-host training needs global batch ({batch_size}) "
                         f"divisible by the global device count ({n})")
    return make_mesh(data=n, model=1)


def _rank_seed(seed: int) -> int:
    return seed + RANK_SEED * process_index()


def load_encoder(path: Optional[str], cfg: TinyVCConfig, seed: int, device) -> Encoder:
    """The frozen encoder from ``path`` (`utils/model_store.py::
    load_encoder_params`: ``.npz``, ``.pt`` or the port's checkpoint
    directory), or drawn at random (with a warning, as the JAX loop does)
    when ``path`` is None."""
    if path is None:
        print("WARNING: no encoder given; using a random encoder")
        enc = Encoder(cfg.encoder, cfg.audio)
        decoder_train.init_params(enc, torch.Generator().manual_seed(seed))
    else:
        enc = encoder_from_jax(load_encoder_params(path, cfg), cfg.encoder)
    return enc.eval().requires_grad_(False).to(device)


def _make_loader(cfg: TinyVCConfig, dataset_dir: str, seed: int):
    """(endless iterator of epochs, each an iterator of numpy batches;
    number of chunks): the native prefetch loader, or the Python loader
    (which also reports each batch's ``idx``) when
    ``TINYVC_NO_NATIVE_LOADER`` is set or the library does not build."""
    ds = Dataset(dataset_dir)
    batch = local_batch_size(cfg.train.batch_size)
    seed = _rank_seed(seed)
    loader = None
    if not os.environ.get("TINYVC_NO_NATIVE_LOADER"):
        try:
            from ..data.native_loader import NativePrefetchLoader

            loader = NativePrefetchLoader(
                dataset_dir, len(ds), batch, chunk_len=cfg.train.chunk_length,
                f0_len=cfg.train.chunk_length // cfg.audio.hop_size,
                sample_rate=cfg.audio.sample_rate, seed=seed)
        except RuntimeError as e:
            print(f"[tinyvc_tpu_torch] native loader unavailable ({e})")
    if loader is not None:
        steps_per_epoch = max(len(ds) // batch, 1)
        print("[tinyvc_tpu_torch] using native prefetch loader")

        def native_epochs():
            while True:
                yield (loader.next() for _ in range(steps_per_epoch))

        return native_epochs(), len(ds)
    dl = DataLoader(ds, batch, seed=seed)
    if len(dl) == 0:
        raise ValueError(f"{dataset_dir!r} holds fewer chunks than one batch ({batch})")
    print("[tinyvc_tpu_torch] using the Python DataLoader")

    def python_epochs():
        while True:
            yield iter(dl)

    return python_epochs(), len(ds)


def _device_data_loader(cfg: TinyVCConfig, dataset_dir: str, seed: int, device):
    """The cache on ``device``: (endless iterator of epochs of batches
    ``{"wave", "f0"}`` gathered there, with the host's ``idx``; number of
    chunks; store ``{"wave" [n, L], "f0" [n, F], "teacher" [n, Ft, D] or
    None, "n"}``). Each batch's rows are ``default_rng(seed)``'s
    ``choice(n, B, replace=n < B)``; the teacher's features are uploaded
    when ``0.teacher.npy`` is in the cache."""
    ds = Dataset(dataset_dir)
    n, L = len(ds), cfg.train.chunk_length
    F = L // cfg.audio.hop_size
    waves = np.empty((n, L), np.float32)
    f0s = np.empty((n, F), np.float32)
    for i in range(n):
        w, f0 = ds[i]
        if w.shape[0] != L:
            raise ValueError(f"chunk {i} has {w.shape[0]} samples, the config {L}")
        waves[i], f0s[i] = w, f0[:F]
    tfeats = None
    if os.path.exists(os.path.join(dataset_dir, "0.teacher.npy")):
        tfeats = np.stack([np.load(os.path.join(dataset_dir, f"{i}.teacher.npy"))
                           for i in range(n)])
    store = {"wave": torch.from_numpy(waves).to(device), "f0": torch.from_numpy(f0s).to(device),
             "teacher": None if tfeats is None else torch.from_numpy(tfeats).to(device), "n": n}
    B = local_batch_size(cfg.train.batch_size)
    rng = np.random.default_rng(_rank_seed(seed))
    steps_per_epoch = max(n // B, 1)

    def epochs():
        while True:
            def epoch():
                for _ in range(steps_per_epoch):
                    idx = rng.choice(n, size=B, replace=n < B)
                    rows = torch.from_numpy(idx).to(device, non_blocking=True)
                    yield {"wave": store["wave"][rows], "f0": store["f0"][rows], "idx": idx}

            yield epoch()

    tbytes = 0 if tfeats is None else tfeats.nbytes
    print(f"[tinyvc_tpu_torch] device-resident dataset: {n} chunks "
          f"({(waves.nbytes + f0s.nbytes + tbytes) / 1e6:.0f} MB"
          + (", incl. teacher features" if tfeats is not None else "") + ") uploaded once")
    return epochs(), n, store


def _window(rng: np.random.Generator, n: int, B: int, k: int, key: np.ndarray, device):
    """(indices ``[k, B]`` on ``device``, the k step keys, the next key) of
    one K-step window, drawn as the JAX loops draw them."""
    idx = np.stack([rng.choice(n, size=B, replace=n < B) for _ in range(k)])
    keys = prng.split(key, k + 1)
    return torch.from_numpy(idx).to(device), keys[1:], keys[0]


def _steps_per_window(requested: int, log_interval: int, *boundaries: int) -> int:
    """``effective_k`` of ``requested`` (0: the log interval), printed."""
    K = effective_k(requested or log_interval, log_interval, *boundaries)
    if K > 1:
        print(f"[tinyvc_tpu_torch] multi-step dispatch: K={K} steps per device call")
    else:
        print(f"[tinyvc_tpu_torch] multi-step dispatch: K={requested or log_interval} "
              "divides no log/save/join boundary; stepping one step at a time")
    return K


def train_encoder(
    cfg: TinyVCConfig,
    dataset_dir: str = "dataset_cache",
    ckpt_dir: str = "models/encoder",
    log_dir: str = "./logs",
    epochs: Optional[int] = None,
    noises_dir: Optional[str] = None,
    teacher_model: str = "microsoft/wavlm-base-plus",
    seed: int = 0,
    device_data: bool = False,
    steps_per_dispatch: int = 0,
    device: str = "cuda",
) -> encoder_train.EncoderTrainState:
    """Train the encoder for ``epochs`` (default ``cfg.train.encoder_epochs``)
    passes over the cache on ``device`` (CUDA by default; it raises when
    CUDA is absent). ``steps_per_dispatch``: with ``device_data``, K steps a
    window (0: auto, the log interval; 1: one step at a time)."""
    device = _resolve_device(device)
    epochs = cfg.train.encoder_epochs if epochs is None else epochs
    mesh = _mesh_or_none(cfg.train.batch_size)
    store = None
    if device_data:
        epochs_iter, _, store = _device_data_loader(cfg, dataset_dir, seed, device)
    else:
        epochs_iter, _ = _make_loader(cfg, dataset_dir, seed)
    state = encoder_train.init_state(cfg, seed, device)
    ckpt = CheckpointManager(ckpt_dir)
    if ckpt.restore(state) is not None:
        print(f"resumed encoder training at step {state.step}")
    if mesh is not None:
        replicate_state(state)
    noise_gen = NoiseGenerator(noises_dir) if noises_dir else None
    teacher = make_teacher(dataset_dir, teacher_model)
    # without a teacher the step drops the distillation term: the content
    # head stays trainable but unforced, never pulled toward zeros
    distill = teacher is not None
    key = prng.prng_key(seed + 1)
    step = state.step
    t0 = time.time()
    writer = MetricsWriter(log_dir) if process_index() == 0 else None

    def log(epoch: int, metrics) -> None:
        if writer is None:
            return
        writer.write(step, {TAG_PITCH: metrics["loss_f0"], TAG_DISTILL: metrics["loss_distill"]})
        print(f"epoch {epoch} step {step} f0={float(metrics['loss_f0']):.4f} "
              f"distill={float(metrics['loss_distill']):.4f} ({time.time() - t0:.0f}s)",
              flush=True)

    K = 1
    if steps_per_dispatch != 1 and store is not None and mesh is None and noise_gen is None \
            and not isinstance(teacher, WavLMTeacher):  # a live teacher runs on the host
        steps_per_epoch = max(store["n"] // cfg.train.batch_size, 1)
        total = epochs * steps_per_epoch
        K = _steps_per_window(steps_per_dispatch, cfg.train.log_interval,
                              cfg.train.save_interval, total, step)
    if K > 1:
        if distill and store["teacher"] is None:
            raise RuntimeError("device-data multi-step distillation needs cached "
                               "{idx}.teacher.npy features covering the whole cache")
        multi = make_encoder_multi_step(cfg, distill)
        rng = np.random.default_rng(seed + MULTI_STEP_SEED)
        done = 0
        while done < total:
            k = min(K, total - done)  # total % K == 0 by construction
            idx, keys, key = _window(rng, store["n"], cfg.train.batch_size, k, key, device)
            metrics = multi(state, store["wave"], store["f0"], store["teacher"], idx, keys)
            step += k
            done += k
            if step % cfg.train.log_interval == 0:
                log(done // steps_per_epoch, metrics)
            if step % cfg.train.save_interval == 0:
                ckpt.save(step, state, cfg)
    else:
        step_fn = encoder_train.make_train_step(cfg, distill=distill, mesh=mesh)
        for epoch in range(epochs):
            for batch in next(epochs_iter):
                wave = batch["wave"]
                # the teacher hears the clean wave; noise is mixed in after
                if isinstance(teacher, CachedTeacher):
                    if "idx" not in batch:
                        raise RuntimeError(
                            "cached teacher features need the index-aware Python DataLoader "
                            "(the native prefetch loader does not report indices); set "
                            "TINYVC_NO_NATIVE_LOADER=1")
                    tfeat = torch.from_numpy(teacher.for_indices(batch["idx"])).to(device)
                elif teacher is not None:
                    clean = torch.as_tensor(wave).detach().cpu()
                    wave16 = resample(clean, cfg.audio.sample_rate, 16000).numpy()
                    tfeat = torch.from_numpy(teacher(wave16)).to(device)
                else:
                    tfeat = None
                if noise_gen is not None:
                    wave = noise_gen.add_noise(torch.as_tensor(wave).cpu().numpy())
                key, sub = prng.split(key)
                metrics = step_fn(state, torch.as_tensor(wave).to(device),
                                  torch.as_tensor(batch["f0"]).to(device), tfeat, sub)
                step += 1
                if step % cfg.train.log_interval == 0:
                    log(epoch, metrics)
                if step % cfg.train.save_interval == 0:
                    ckpt.save(step, state, cfg)
    ckpt.save(state.step, state, cfg)
    if writer is not None:
        writer.close()
    return state


def train_decoder(
    cfg: TinyVCConfig,
    dataset_dir: str = "dataset_cache",
    encoder_path: Optional[str] = None,
    ckpt_dir: str = "models/decoder",
    log_dir: str = "./logs",
    max_steps: Optional[int] = None,
    spec_loss_type: str = "ms-stft",
    seed: int = 0,
    device: str = "cuda",
    init_decoder: Optional[str] = None,
    device_data: bool = False,
    steps_per_dispatch: int = 0,
) -> decoder_train.TrainState:
    """Train the decoder to ``max_steps`` (default ``cfg.train.max_steps``)
    on ``device`` (CUDA by default; it raises when CUDA is absent).
    ``steps_per_dispatch``: with ``device_data``, K GAN steps a window (0:
    auto, the log interval; 1: one step at a time)."""
    device = _resolve_device(device)
    max_steps = cfg.train.max_steps if max_steps is None else max_steps
    mesh = _mesh_or_none(cfg.train.batch_size)
    store = None
    if device_data:
        epochs_iter, _, store = _device_data_loader(cfg, dataset_dir, seed, device)
    else:
        epochs_iter, _ = _make_loader(cfg, dataset_dir, seed)
    encoder = load_encoder(encoder_path, cfg, seed, device)
    state = decoder_train.init_state(cfg, seed + 1, device)
    if init_decoder is not None:
        init = train_state_from_jax(load_npz(init_decoder), cfg.decoder, cfg.audio, device)
        state.decoder, state.gen_opt = init.decoder, init.gen_opt
    ckpt = CheckpointManager(ckpt_dir)
    if ckpt.restore(state) is not None:
        print(f"resumed decoder training at step {state.step} "
              "(optimizer state and join gate preserved)")
    if mesh is not None:
        replicate(encoder.parameters())
        replicate_state(state)

    key = prng.prng_key(seed + 2)
    step = state.step
    t0 = t_log = time.time()
    s_log = step
    writer = MetricsWriter(log_dir) if process_index() == 0 else None

    def log(d_join: bool, metrics) -> None:
        nonlocal t_log, s_log
        if writer is None:
            return
        scalars = {TAG_SPEC: metrics["loss_spec"], TAG_DSP: metrics["loss_dsp"]}
        if d_join:
            scalars[TAG_G_ADV] = metrics["loss_adv"]
            scalars[TAG_FEAT] = metrics["loss_feat"]
            scalars[TAG_D_ADV] = metrics["loss_d"]
        skipped = int(metrics["skipped_g"]) + int(metrics.get("skipped_d", 0))
        if skipped:
            scalars[TAG_SKIPPED] = skipped
        writer.write(step, scalars)
        now = time.time()
        sps = (step - s_log) / max(now - t_log, 1e-9)
        t_log, s_log = now, step
        print(f"step {step} spec={float(metrics['loss_spec']):.4f} "
              f"dsp={float(metrics['loss_dsp']):.4f} "
              + (f"d={float(metrics['loss_d']):.4f} " if d_join else "")
              + (f"SKIPPED={skipped} " if skipped else "")
              + f"({sps:.2f} steps/s, {now - t0:.0f}s)", flush=True)

    tc = cfg.train
    K = 1
    if steps_per_dispatch != 1 and store is not None and mesh is None:
        K = _steps_per_window(steps_per_dispatch, tc.log_interval, tc.save_interval,
                              tc.discriminator_join, max_steps, step)
    if K > 1:
        windows = {d_join: make_decoder_multi_step(cfg, d_join, spec_loss_type)
                   for d_join in (False, True)}
        rng = np.random.default_rng(seed + MULTI_STEP_SEED)
        while step < max_steps:
            k = min(K, max_steps - step)
            d_join = step >= tc.discriminator_join  # K divides the join: no window straddles it
            idx, keys, key = _window(rng, store["n"], tc.batch_size, k, key, device)
            metrics = windows[d_join](state, encoder, store["wave"], idx, keys)
            step += k
            if step % tc.log_interval == 0:
                log(d_join, metrics)
            if step % tc.save_interval == 0:
                ckpt.save(step, state, cfg)
    else:
        steps = {d_join: decoder_train.make_train_step(cfg, d_join, spec_loss_type, mesh=mesh)
                 for d_join in (False, True)}
        while step < max_steps:
            for batch in next(epochs_iter):
                if step >= max_steps:
                    break
                d_join = step >= tc.discriminator_join
                key, sub = prng.split(key)
                metrics = steps[d_join](state, encoder, torch.as_tensor(batch["wave"]).to(device),
                                        sub)
                step += 1
                if step % tc.log_interval == 0:
                    log(d_join, metrics)
                if step % tc.save_interval == 0:
                    ckpt.save(step, state, cfg)
    ckpt.save(state.step, state, cfg)
    if writer is not None:
        writer.close()
    return state
