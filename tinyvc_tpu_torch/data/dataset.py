"""Dataset over the JAX package's training cache (counterpart of
`tinyvc_tpu/data/dataset.py`): ``{i}.wav`` at 24 kHz and ``{i}.f0.npy`` per
chunk, all chunks one length, so every batch has one shape.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from ..utils.audio_io import load_audio


class Dataset:
    """Map-style dataset: ``(wave [L], f0 [F])`` float32 per index."""

    def __init__(self, dir_path: str = "dataset_cache"):
        self.dir_path = dir_path
        n = 0
        while os.path.exists(os.path.join(dir_path, f"{n}.wav")):
            n += 1
        if n == 0:
            raise FileNotFoundError(f"no {{idx}}.wav files under {dir_path!r}")
        self.length = n

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        wave, _ = load_audio(os.path.join(self.dir_path, f"{idx}.wav"))
        wave = wave.mean(axis=0)  # mono mixdown, as the JAX package's loader does
        f0 = np.load(os.path.join(self.dir_path, f"{idx}.f0.npy"))
        return wave.astype(np.float32), f0.astype(np.float32).reshape(-1)


class DataLoader:
    """Shuffled batches ``{"wave": [B, L], "f0": [B, F], "idx": [B]}`` as
    numpy arrays, the ragged tail dropped. Each pass over the data draws its
    order from one ``np.random.default_rng(seed)``, as the JAX package's
    Python loader does, so both see the same batches."""

    def __init__(self, dataset: Dataset, batch_size: int = 16, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.ds))
        self.rng.shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            waves, f0s = zip(*(self.ds[int(i)] for i in idx))
            yield {"wave": np.stack(waves), "f0": np.stack(f0s),
                   "idx": np.asarray(idx, dtype=np.int64)}
