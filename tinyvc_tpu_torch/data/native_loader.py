"""ctypes bindings to the port's native audio library (counterpart of
`tinyvc_tpu/data/native_loader.py`): WAV decode and a multithreaded
prefetching batch loader.

The library is built at first use from the port's own source,
`tinyvc_tpu_torch/native/tinyvc_audio.cc`, by one ``g++`` into
``tinyvc_tpu_torch/kernels/_build/native-<hash of the source>/``, written
under a temporary name and renamed, so concurrent first uses do not read a
half-written file. Nothing here reads the library that the JAX package
builds in the repository's ``native`` directory. When the build fails,
:func:`load_library` returns None and callers take the Python paths
(`data/dataset.py`, `utils/audio_io.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "tinyvc_audio.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "kernels" / "_build"
LIB_NAME = "libtinyvc_audio.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"native-{digest}" / LIB_NAME


def build() -> Optional[Path]:
    """Build the library unless it is there; its path, or None when no C++
    compiler could build it."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, timeout=300)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _declare(lib) -> None:
    P, I, L = ctypes.POINTER, ctypes.c_int, ctypes.c_long
    f32p = P(ctypes.c_float)
    lib.tvc_load_wav.restype = L
    lib.tvc_load_wav.argtypes = [ctypes.c_char_p, P(f32p), P(I), P(I)]
    lib.tvc_free.argtypes = [ctypes.c_void_p]
    lib.tvc_loader_create.restype = ctypes.c_void_p
    lib.tvc_loader_create.argtypes = [ctypes.c_char_p, I, I, I, I, I, I, ctypes.c_uint64]
    lib.tvc_loader_next.restype = I
    lib.tvc_loader_next.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.tvc_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.tvc_loader_error_count.restype = L
    lib.tvc_loader_error_count.argtypes = [ctypes.c_void_p]


def load_library():
    """The loaded library (built at the first call), or None when it does
    not build."""
    global _lib, _tried
    if not _tried:
        _tried = True
        path = build()
        if path is not None:
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
    return _lib


class NativeAudio:
    """WAV decode through the native library."""

    def __init__(self, lib):
        self.lib = lib

    @classmethod
    def maybe_create(cls) -> Optional["NativeAudio"]:
        lib = load_library()
        return cls(lib) if lib is not None else None

    def load_wav(self, path: str) -> Optional[Tuple[np.ndarray, int]]:
        """-> (``[C, L]`` float32, sample rate), or None when the file does
        not decode."""
        out = ctypes.POINTER(ctypes.c_float)()
        sr, ch = ctypes.c_int(), ctypes.c_int()
        frames = self.lib.tvc_load_wav(path.encode(), ctypes.byref(out), ctypes.byref(sr),
                                       ctypes.byref(ch))
        if frames < 0:
            return None
        data = np.ctypeslib.as_array(out, shape=(frames * ch.value,)).copy()
        self.lib.tvc_free(out)
        return data.reshape(frames, ch.value).T.copy(), sr.value  # interleaved -> [C, L]


class NativePrefetchLoader:
    """An endless stream of shuffled ``{"wave", "f0"}`` batches, prefetched
    by C++ worker threads (each pass over the cache reshuffled by one
    ``mt19937(seed)``). With one thread the batches come in a fixed order;
    with more, two prefetched batches may swap. A chunk that does not decode
    is zero-filled and counted, and :meth:`next` prints a warning when the
    count grows."""

    def __init__(self, cache_dir: str, num_items: int, batch_size: int, chunk_len: int = 48000,
                 f0_len: int = 100, sample_rate: int = 24000, num_threads: int = 2,
                 seed: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("the native audio library does not build here (no C++ "
                               "compiler?); use the Python DataLoader")
        self.lib = lib
        self.batch, self.chunk_len, self.f0_len = batch_size, chunk_len, f0_len
        self._reported_errors = 0
        self._handle = lib.tvc_loader_create(cache_dir.encode(), num_items, batch_size,
                                             chunk_len, f0_len, sample_rate, num_threads, seed)

    def next(self) -> dict:
        wave = np.empty((self.batch, self.chunk_len), np.float32)
        f0 = np.empty((self.batch, self.f0_len), np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        if self.lib.tvc_loader_next(self._handle, wave.ctypes.data_as(f32p),
                                    f0.ctypes.data_as(f32p)) != 0:
            raise RuntimeError("native loader stopped")
        errs = self.error_count
        if errs > self._reported_errors:
            # a corrupt or half-written cache file decodes to silence: say so
            print(f"[tinyvc_tpu_torch] WARNING: native loader hit {errs} decode failure(s); "
                  "affected samples were zero-filled. Check the dataset cache for corrupt "
                  "{idx}.wav / {idx}.f0.npy files.")
            self._reported_errors = errs
        return {"wave": wave, "f0": f0}

    @property
    def error_count(self) -> int:
        """Decode failures (zero-filled sample slots) so far."""
        return int(self.lib.tvc_loader_error_count(self._handle))

    def close(self) -> None:
        if self._handle:
            self.lib.tvc_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
