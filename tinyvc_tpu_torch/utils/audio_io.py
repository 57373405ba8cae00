"""Audio file I/O (counterpart of `tinyvc_tpu/utils/audio_io.py`).

``load_audio(path) -> ([C, L] float32, sample_rate)`` at the file's own
rate; callers average the channels and resample (`dsp/resample.py`). WAV is
decoded by the port's C++ library when it builds (`data/native_loader.py`),
else by ``scipy.io.wavfile`` (24-bit through ``wave``), as the JAX package
does; both give the same samples. Other formats go through ffmpeg, with the
JAX package's error when it is not installed.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave as _wave
from typing import Tuple

import numpy as np
from scipy.io import wavfile

def _load_wav(path: str) -> Tuple[np.ndarray, int]:
    """PCM16/24/32, uint8 or float32 WAV -> ([C, L] float32 in [-1, 1], sr)."""
    try:
        sr, data = wavfile.read(path)
    except ValueError:
        # 24-bit or other oddities: a minimal parse through the wave module
        with _wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            sw = w.getsampwidth()
            ch = w.getnchannels()
            raw = w.readframes(n)
        if sw != 3:
            raise
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        data = ((a[:, 0].astype(np.int32) | (a[:, 1].astype(np.int32) << 8)
                 | (a[:, 2].astype(np.int32) << 16)) << 8) >> 8
        data = (data / 2147483648.0 * 256).astype(np.float32).reshape(-1, ch)
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data.T.copy(), sr


def _load_via_ffmpeg(path: str) -> Tuple[np.ndarray, int]:
    """One mono decode at the source rate, read with ffprobe (48 kHz when
    ffprobe cannot tell)."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode {path!r}: non-WAV formats need ffmpeg, which is "
            "not installed in this environment"
        )
    sr = None
    ffprobe = shutil.which("ffprobe")
    if ffprobe is not None:
        probe = subprocess.run(
            [ffprobe, "-v", "error", "-select_streams", "a:0",
             "-show_entries", "stream=sample_rate",
             "-of", "default=noprint_wrappers=1:nokey=1", path],
            capture_output=True, text=True,
        )
        try:
            sr = int(probe.stdout.strip().splitlines()[0])
        except (ValueError, IndexError):
            sr = None
    if sr is None:
        sr = 48000  # last resort; the caller resamples
    out = subprocess.run([ffmpeg, "-i", path, "-f", "f32le", "-ac", "1", "-ar", str(sr), "-"],
                         capture_output=True, check=True)
    return np.frombuffer(out.stdout, dtype=np.float32)[None, :].copy(), sr


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """-> (``[C, L]`` float32, sample_rate): WAV by the native library (by
    scipy when it is not built or the file does not decode there), the rest
    by ffmpeg."""
    if os.path.splitext(path)[1].lower() == ".wav":
        from ..data.native_loader import NativeAudio

        native = NativeAudio.maybe_create()
        out = native.load_wav(path) if native is not None else None
        return out if out is not None else _load_wav(path)
    return _load_via_ffmpeg(path)


def save_wav(path: str, wave: np.ndarray, sample_rate: int = 24000) -> None:
    """``[L]`` or ``[C, L]`` float waveform -> 16-bit PCM WAV."""
    wave = np.asarray(wave)
    if wave.ndim == 2:
        wave = wave.T  # scipy takes [L, C]
    pcm = np.clip(wave, -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))
