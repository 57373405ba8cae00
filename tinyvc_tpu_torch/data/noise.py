"""Noise augmentation for denoising distillation (counterpart of
`tinyvc_tpu/data/noise.py`): with probability ``p`` a row gets a random
crop of a random noise file at a random gain. The draws come from one
``np.random.default_rng(seed)`` in the JAX package's order, so both mix the
same noise; files at another rate are resampled by `dsp/resample.py` on the
CPU."""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
import torch

from ..dsp.resample import resample
from ..utils.audio_io import load_audio


class NoiseGenerator:
    def __init__(self, dir_path: str, sample_rate: int = 24000, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.waveforms: List[np.ndarray] = []
        for fmt in ("mp3", "ogg", "wav"):
            for p in sorted(Path(dir_path).glob(f"*.{fmt}")):
                wf, sr = load_audio(str(p))
                wf = wf.mean(axis=0)
                if sr != sample_rate:
                    wf = resample(torch.from_numpy(wf[None]), sr, sample_rate).numpy()[0]
                self.waveforms.append(wf.astype(np.float32))

    def add_noise(self, xs: np.ndarray, p: float = 0.3) -> np.ndarray:
        """``xs`` ``[B, L]`` -> noisy ``[B, L]`` (a new array)."""
        out = xs.copy()
        for i in range(xs.shape[0]):
            if self.rng.random() < p and self.waveforms:
                noise = self.waveforms[self.rng.integers(len(self.waveforms))]
                if noise.shape[0] > xs.shape[1]:
                    s = int(self.rng.integers(0, noise.shape[0] - xs.shape[1]))
                    crop = noise[s: s + xs.shape[1]]
                else:
                    crop = np.pad(noise, (0, xs.shape[1] - noise.shape[0]))
                out[i] = out[i] + crop * self.rng.random()
        return out
