"""Dataset preprocessing: decode, mix to mono, resample to 24 kHz, cut 2 s
chunks, label their f0 in batches on the device, and write the cache
(counterpart of `tinyvc_tpu/data/preprocess.py`).

The cache is ``{i}.wav`` (16-bit PCM at ``sample_rate``) and ``{i}.f0.npy``
per chunk, in the order of the files (``mp3``, then ``wav``, then ``ogg``,
each sorted) and of the chunks within each; chunks are labelled ``f0_batch``
at a time by `dsp/f0.py::estimate_f0` on ``device``, from the chunk before
its 16-bit rounding, as the JAX package labels them.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
import torch

from ..dsp.f0 import estimate_f0
from ..dsp.resample import resample
from ..infer.generator import _resolve_device
from ..utils.audio_io import load_audio, save_wav


def find_audio_files(root: str, max_files: int = -1) -> List[Path]:
    paths: List[Path] = []
    for ext in ("mp3", "wav", "ogg"):
        paths += sorted(Path(root).glob(f"**/*.{ext}"))
    if max_files != -1:
        paths = paths[:max_files]
    return paths


def chunk_waveform(wf: np.ndarray, length: int) -> List[np.ndarray]:
    """``[L]`` -> float32 chunks of ``length``, the last zero-padded."""
    chunks = []
    for s in range(0, len(wf), length):
        c = wf[s: s + length]
        if len(c) < length:
            c = np.pad(c, (0, length - len(c)))
        chunks.append(c.astype(np.float32))
    return chunks


def preprocess(input_dir: str, output_dir: str = "dataset_cache", length: int = 48000,
               sample_rate: int = 24000, max_files: int = -1, f0_algorithm: str = "yin",
               f0_batch: int = 64, device: str = "cuda") -> int:
    """Write the cache of ``input_dir``'s audio to ``output_dir``; returns
    the number of chunks. ``device`` (CUDA by default; it raises when CUDA
    is absent) runs the resampling and the f0 labelling."""
    device = _resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    pending: List[np.ndarray] = []
    counter = 0

    def flush(chunks: List[np.ndarray], counter: int) -> int:
        if not chunks:
            return counter
        batch = torch.from_numpy(np.stack(chunks)).to(device)
        f0 = estimate_f0(batch, sample_rate, 480, f0_algorithm).cpu().numpy()
        for i, chunk in enumerate(chunks):
            save_wav(str(out / f"{counter + i}.wav"), chunk, sample_rate)
            np.save(out / f"{counter + i}.f0.npy", f0[i])
        return counter + len(chunks)

    for path in find_audio_files(input_dir, max_files):
        wf, sr = load_audio(str(path))
        wf = wf.mean(axis=0)
        if sr != sample_rate:
            wf = resample(torch.from_numpy(wf[None]).to(device), sr, sample_rate).cpu().numpy()[0]
        pending.extend(chunk_waveform(wf, length))
        while len(pending) >= f0_batch:
            counter = flush(pending[:f0_batch], counter)
            pending = pending[f0_batch:]
    return flush(pending, counter)
