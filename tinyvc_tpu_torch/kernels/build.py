"""Build, load and launch the CUDA kernels of `csrc/`.

At first use, one ``nvcc`` per ``csrc/*.cu`` file, all started together,
compiles each for ``sm_90a`` into an object, and one more links them into a
shared library with a plain C interface,
``_build/<hash of the sources>/libtinyvc_kernels.so``. No source includes
PyTorch's headers, so the build takes seconds; the library is loaded with
``ctypes`` and every pointer and the stream are passed as ``c_void_p``.
Every wrapper launches through :func:`launch`, which runs the call under
the tensor's device and on that device's current stream. The library counts
its kernel launches on the host (`csrc/launch_count.cuh`);
:func:`launch_count` reads the count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, List, Tuple

import torch

KERNEL_DIR = Path(__file__).resolve().parent
CSRC = KERNEL_DIR / "csrc"
BUILD_DIR = KERNEL_DIR / "_build"
LIB_NAME = "libtinyvc_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
]

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# name -> argtypes; every function returns its cudaGetLastError() as an int
SIGNATURES = {
    "tvc_oscillator": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "tvc_noise": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "tvc_upsample_linear": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "tvc_downsample_linear": [_P, _P, _LL, _I, _I, _I, _P],
    "tvc_conv3": [_P] * 4 + [_I] * 6 + [_P],
    "tvc_down_chain": [_P] * 13 + [_I] * 6 + [_P],
    "tvc_up_chain": [_P] * 13 + [_I] * 8 + [_P],
    "tvc_spectrogram": [_P] * 4 + [_I] * 4 + [_P],
    "tvc_knn": [_P] * 9 + [_I] * 6 + [_F, _F, _P],
    "tvc_oscillator_amps_grad": [_P] * 4 + [_I] * 4 + [_F, _F, _P],
    "tvc_resample_grad": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "tvc_up_chain_grad": [_P] * 20 + [_LL] + [_I] * 7 + [_P],
    "tvc_down_chain_grad": [_P] * 21 + [_LL] + [_I] * 6 + [_P],
    "tvc_conv3_grad": [_P] * 7 + [_LL] + [_I] * 6 + [_P],
    "tvc_up_chain_grad_bf16": [_P] * 20 + [_I] * 6 + [_P],
    "tvc_down_chain_grad_bf16": [_P] * 21 + [_I] * 5 + [_P],
    "tvc_conv3_grad_bf16": [_P] * 9 + [_I] * 5 + [_P],
    "tvc_mrd_fwd": [_P] * 9 + [_I] * 18 + [_P],
    "tvc_mrd_dx": [_P] * 12 + [_I] * 19 + [_P],
    "tvc_mrd_dw": [_P] * 3 + [_LL] + [_P] * 2 + [_I] * 15 + [_P],
    "tvc_mrd_dw_bf16": [_P, _P, _I, _P, _LL, _P],
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


def build_commands(out: Path, nvcc: str = "nvcc") -> Tuple[List[List[str]], List[str]]:
    """(one compile command per source, the link command) for ``out``; the
    objects go beside it."""
    objects = [out.parent / f"{s.stem}.{os.getpid()}.o" for s in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(sources(), objects)]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(out),
            *[str(o) for o in objects]]
    return compiles, link


def build() -> Path:
    """Compile the library unless this source hash is already built: every
    source at once, one ``nvcc`` each, then the link."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    compiles, link = build_commands(tmp, nvcc)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = [p.communicate()[0] for p in procs]
    failed = [(cmd[-1], p.returncode, log) for cmd, p, log in zip(compiles, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src} (exit code {rc}):\n{log}" for src, rc, log in failed))
    proc = subprocess.run(link, capture_output=True, text=True)
    for cmd in compiles:
        os.remove(cmd[cmd.index("-o") + 1])
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed with exit code {proc.returncode}:\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs) + proc.stderr + proc.stdout
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
        lib.tvc_launch_count.argtypes = []
        lib.tvc_launch_count.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def launch_count() -> int:
    """Kernels the library has launched in this process: every launch of
    every C entry point adds one on the host, so the count loses none
    (a profiler's kernel records may be dropped)."""
    return library().tvc_launch_count()


def check_input(name: str, t: torch.Tensor, ndim: int,
                dtypes: Iterable[torch.dtype] = (torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``ndim`` dims and
    of one of ``dtypes`` (the types the kernel takes; nothing is converted)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    dtypes = tuple(dtypes)
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(kernel: str, t: torch.Tensor, *args) -> None:
    """Call the library's C function ``kernel`` with ``args`` (tensors are
    passed as their data pointers) and the current stream of ``t``'s device,
    with that device current for the call; raise on a non-zero status."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(t.device):
        rc = getattr(library(), kernel)(*ptrs, torch.cuda.current_stream(t.device).cuda_stream)
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
