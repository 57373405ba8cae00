"""WAV file I/O at the model's rate.

Counterpart of `tinyvc_tpu/utils/audio_io.py` for the one format this slice
reads and writes: WAV through ``scipy.io.wavfile``. Resampling is not
ported, so a file at another rate than the model's is refused.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

SAMPLE_RATE = 24000


def load_audio(path: str, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """-> mono float32 waveform ``[L]`` in [-1, 1] (channels averaged)."""
    sr, data = wavfile.read(path)
    if sr != sample_rate:
        raise ValueError(f"{path}: {sr} Hz, expected {sample_rate} Hz")
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data


def save_wav(path: str, wave: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """``[L]`` float waveform -> 16-bit PCM WAV."""
    pcm = np.clip(np.asarray(wave, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))
