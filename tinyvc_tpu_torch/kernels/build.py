"""Build and load the CUDA kernels of `csrc/`.

One ``nvcc`` call compiles every ``csrc/*.cu`` file for ``sm_90a`` into one
shared library with a plain C interface, at first use, into
``_build/<hash of the sources>/libtinyvc_kernels.so``. No source includes
PyTorch's headers, so the build takes seconds; the library is loaded with
``ctypes`` and every pointer and the stream are passed as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List

import torch

KERNEL_DIR = Path(__file__).resolve().parent
CSRC = KERNEL_DIR / "csrc"
BUILD_DIR = KERNEL_DIR / "_build"
LIB_NAME = "libtinyvc_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
]

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# name -> argtypes; every function returns its cudaGetLastError() as an int
SIGNATURES = {
    "tvc_oscillator": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "tvc_noise": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "tvc_upsample_linear": [_P, _P, _LL, _I, _I, _P],
    "tvc_downsample_linear": [_P, _P, _LL, _I, _I, _P],
    "tvc_conv3": [_P] * 4 + [_I] * 5 + [_P],
    "tvc_down_chain": [_P] * 11 + [_I] * 5 + [_P],
    "tvc_up_chain": [_P] * 11 + [_I] * 6 + [_P],
}

_lib = None
build_seconds = None  # wall time of this process's build, None if loaded from disk
build_log = ""


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / _source_hash() / LIB_NAME


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_command(out: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *[str(s) for s in sources()]]


def build() -> Path:
    """Compile the library unless this source hash is already built."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(build_command(tmp, nvcc_path()), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stderr + proc.stdout
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_input(name: str, t: torch.Tensor, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``ndim`` dims."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_status(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError {rc}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when they lie on CUDA; raises for any other placement."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must all be on the CPU or all on CUDA, got {kinds}")
