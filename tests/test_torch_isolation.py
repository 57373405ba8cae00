"""The port stands alone and hides no fallback: `tinyvc_tpu_torch`,
`chip_smoke.py` and the distributed tests' worker (`tests/
torch_dist_worker.py`) import nothing of JAX or `tinyvc_tpu`; the entry points refuse
to run on a machine without CUDA unless the CPU is asked for; and the kernel
build is one ``nvcc`` per source for ``sm_90a``, started together, and one
link."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models", "two_speaker")

BLOCKER = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "tinyvc_tpu", "triton")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {root!r})
    import tinyvc_tpu_torch
    names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
        tinyvc_tpu_torch.__path__, "tinyvc_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    # the distributed tests' worker runs as a script of the port alone
    spec = importlib.util.spec_from_file_location("torch_dist_worker", {worker!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(" ".join(names))
    print(len(names))
""")
STREAMING_MODULES = {"tinyvc_tpu_torch.dsp.resample", "tinyvc_tpu_torch.utils.torch_compat",
                     "tinyvc_tpu_torch.utils.model_store", "tinyvc_tpu_torch.infer.stream",
                     "tinyvc_tpu_torch.cli.infer_streaming"}
CHUNKED_MODULES = {"tinyvc_tpu_torch.parallel", "tinyvc_tpu_torch.parallel.time_shard",
                   "tinyvc_tpu_torch.infer.index", "tinyvc_tpu_torch.cli.extract_index"}
DISTRIBUTED_MODULES = {"tinyvc_tpu_torch.parallel.mesh", "tinyvc_tpu_torch.parallel.sharded_knn"}
EXPORT_MODULES = {f"tinyvc_tpu_torch.{m}" for m in (
    "infer.export", "cli.export", "cli.export_params", "cli.infer_webui",
    "cli.audio_device_list")}
TRAINING_MODULES = {f"tinyvc_tpu_torch.{m}" for m in (
    "dsp.f0", "data.noise", "data.preprocess", "data.native_loader", "train.encoder_train",
    "train.teacher", "train.multi_step", "utils.torch_compat_disc", "cli.preprocess",
    "cli.precompute_teacher", "cli.train_encoder")}


def test_port_imports_nothing_of_jax():
    worker = os.path.join(ROOT, "tests", "torch_dist_worker.py")
    proc = subprocess.run([sys.executable, "-c", BLOCKER.format(root=ROOT, worker=worker)],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names, count = proc.stdout.strip().splitlines()[-2:]
    assert int(count) >= 61  # every module was imported
    assert STREAMING_MODULES <= set(names.split())
    assert CHUNKED_MODULES <= set(names.split())
    assert TRAINING_MODULES <= set(names.split())
    assert DISTRIBUTED_MODULES <= set(names.split())
    assert EXPORT_MODULES <= set(names.split())


NATIVE_PROBE = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from tinyvc_tpu_torch.data import native_loader
    from tinyvc_tpu_torch.utils.audio_io import load_audio
    load_audio({wav!r})
    lib = native_loader.load_library()
    maps = [ln.split()[-1] for ln in open("/proc/self/maps") if "libtinyvc_audio" in ln]
    print(lib is not None, sorted(set(maps)))
""")


def test_native_library_is_the_ports_own_build():
    """The port builds and loads its own copy of the audio library under
    ``tinyvc_tpu_torch/kernels/_build/`` and never the JAX package's
    ``native/libtinyvc_audio.so``, in the file or in the process."""
    wav = os.path.join(ROOT, "demo", "two_speaker", "source_A.wav")
    proc = subprocess.run([sys.executable, "-c", NATIVE_PROBE.format(root=ROOT, wav=wav)],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    built, maps = proc.stdout.strip().split(" ", 1)
    if built == "True":
        assert maps != "[]" and os.path.join(ROOT, "native") not in maps
        assert os.path.join(ROOT, "tinyvc_tpu_torch", "kernels", "_build") in maps
    for dirpath, _, files in os.walk(os.path.join(ROOT, "tinyvc_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert "native/libtinyvc_audio" not in f.read(), name


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from tinyvc_tpu_torch.infer.generator import VoiceConverter

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VoiceConverter({}, {})


def test_streaming_default_device_is_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from tinyvc_tpu_torch.infer.stream import StreamConverter

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamConverter({}, {}, np.zeros((4, 768), np.float32))
    out = tmp_path / "out.wav"
    proc = _cli(["-encp", os.path.join(MODELS, "encoder_B.npz"),
                 "-decp", os.path.join(MODELS, "decoder_B.npz"),
                 "-idx", os.path.join(MODELS, "index_B.npy"),
                 "--wav-in", os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"),
                 "--wav-out", str(out)], tmp_path, module="infer_streaming")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not out.exists()


def _cli(args, cwd, module="infer"):
    return subprocess.run([sys.executable, "-m", f"tinyvc_tpu_torch.cli.{module}", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})


def test_cli_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from tinyvc_tpu_torch.cli import infer as cli
    from tinyvc_tpu_torch.kernels import noise, oscillator, resample
    from tinyvc_tpu_torch.utils.audio_io import load_audio, save_wav

    inputs, outputs = tmp_path / "in", tmp_path / "out"
    inputs.mkdir()
    wave = load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))[0][0, :24000]
    save_wav(str(inputs / "utt.wav"), wave)
    args = ["-i", str(inputs), "-o", str(outputs),
            "-encp", os.path.join(MODELS, "encoder_B.npz"),
            "-decp", os.path.join(MODELS, "decoder_B.npz"),
            "-idx", os.path.join(MODELS, "index_B.npy"), "-p", "11.99"]
    proc = _cli(args, tmp_path)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (outputs / "utt.wav").exists()

    counters = (oscillator.oscillator_bank, noise.oscillate_noise_hashed, resample.upsample_linear)
    before = [c.launches for c in counters]
    cli.main(args + ["--device", "cpu"])
    out, sr = load_audio(str(outputs / "utt.wav"))
    out = out[0]
    assert sr == 24000 and out.shape == wave.shape
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01
    assert [c.launches for c in counters] == before == [0, 0, 0]


def test_kernel_build_recipe():
    from tinyvc_tpu_torch.kernels import build

    out = build.KERNEL_DIR / "_build" / "x" / build.LIB_NAME
    compiles, link = build.build_commands(out)
    sources = build.sources()
    assert {s.name for s in sources} == {"oscillator.cu", "noise.cu", "resample.cu",
                                        "filter_stage.cu", "filter_stage_bwd.cu",
                                        "spectrogram.cu", "knn.cu", "mrd_dw.cu", "mrd_fwd.cu",
                                        "mrd_dx.cu"}
    assert len(compiles) == len(sources)  # one nvcc call for each kernel source
    for cmd, src in zip(compiles, sources):
        assert "arch=compute_90a,code=sm_90a" in cmd and "-gencode" in cmd
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd) and cmd[-1] == str(src)
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert "-shared" in link and link[link.index("-o") + 1] == str(out)
    assert link[-len(objects):] == objects
    for path in build.CSRC.iterdir():
        assert "#include <torch" not in path.read_text(), path
        assert "#include <ATen" not in path.read_text(), path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "tinyvc_tpu_torch/kernels/_build/" in f.read().split()
    # every C entry point has argtypes, pointers and the stream as c_void_p
    import ctypes

    for name, argtypes in build.SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name
