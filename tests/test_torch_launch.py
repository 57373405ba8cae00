"""Every kernel launch of the port goes through `kernels/build.py::launch`,
which runs the C call under the tensor's device, on that device's current
stream, and raises on a non-zero status; and `check_input` refuses a dtype
the kernel does not take instead of converting it. Checked here with
stand-ins for the card (the launch on a real second device is
`chip_smoke.py`'s)."""

import contextlib
import re
from pathlib import Path

import pytest
import torch

from tinyvc_tpu_torch.kernels import build


class _Stream:
    def __init__(self, device):
        self.cuda_stream = 1000 + device.index


class _FakeCuda:
    """torch.cuda's device context and current stream, recorded."""

    def __init__(self):
        self.current = 0
        self.calls = []

    @contextlib.contextmanager
    def device(self, dev):
        prev, self.current = self.current, torch.device(dev).index
        try:
            yield
        finally:
            self.current = prev

    def current_stream(self, dev):
        return _Stream(torch.device(dev))


class _FakeTensor:
    def __init__(self, device="cuda:1", dtype=torch.float32, ndim=2, contiguous=True):
        self.device, self.dtype = torch.device(device), dtype
        self._ndim, self._contiguous = ndim, contiguous
        self.shape = (2,) * ndim

    def dim(self):
        return self._ndim

    def is_contiguous(self):
        return self._contiguous


def _fake_library(fake, rc=0):
    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                fake.calls.append((name, fake.current, args))
                return rc
            return fn
    return Lib()


@pytest.mark.parametrize("index", (0, 1, 3))
def test_launch_runs_under_the_tensors_device(monkeypatch, index):
    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    monkeypatch.setattr(build, "library", lambda: _fake_library(fake))
    t, x = _FakeTensor(f"cuda:{index}"), torch.zeros(3)
    build.launch("tvc_example", t, x, None, 7, 2.5)
    assert fake.calls == [("tvc_example", index, (x.data_ptr(), None, 7, 2.5, 1000 + index))]
    assert fake.current == 0  # the previous device is current again


def test_launch_raises_on_a_failed_status(monkeypatch):
    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    monkeypatch.setattr(build, "library", lambda: _fake_library(fake, rc=1))
    t = _FakeTensor()
    with pytest.raises(RuntimeError, match="tvc_example: launch failed with cudaError 1"):
        build.launch("tvc_example", t, t)


def test_every_wrapper_launches_through_the_helper():
    """No module but `build.py` calls into the library: each C entry point
    is reached by one `build.launch` call in its wrapper."""
    kernels = Path(build.__file__).parent
    called = set()
    for path in kernels.glob("*.py"):
        text = path.read_text()
        if path.name != "build.py":
            assert "library()" not in text and "cuda_stream" not in text, path.name
        called |= set(re.findall(r'build\.launch\(\s*"(tvc_\w+)"', text))
    assert called == set(build.SIGNATURES)


def test_every_kernel_launch_is_counted():
    """Every `<<<grid, block, smem, stream>>>` in `csrc/` passes its stream
    through `tvc::counted` (`csrc/launch_count.cuh`), so the library's host
    count (`build.launch_count`), on which `chip_smoke.py` checks each
    call's launches, misses none; every source that launches includes the
    header."""
    launches = 0
    for path in sorted(build.CSRC.glob("*.cu")):
        text = path.read_text()
        configs = re.findall(r"<<<(.*?)>>>", text, re.S)
        for cfg in configs:
            assert re.search(r",\s*tvc::counted\((.|\n)*\)\s*$", cfg), (path.name, cfg)
        if configs:
            assert '#include "launch_count.cuh"' in text, path.name
        launches += len(configs)
    assert launches > 0


def test_check_input_refuses_other_dtypes():
    build.check_input("x", _FakeTensor(), 2)
    build.check_input("x", _FakeTensor(dtype=torch.bfloat16), 2, (torch.float32, torch.bfloat16))
    with pytest.raises(ValueError, match="expected torch.float32, got torch.bfloat16"):
        build.check_input("x", _FakeTensor(dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        build.check_input("x", _FakeTensor("cpu"), 2)
    with pytest.raises(ValueError, match="contiguous"):
        build.check_input("x", _FakeTensor(contiguous=False), 2)


@pytest.mark.parametrize("mangled, name", [
    ("_ZN43_GLOBAL__N__079cb419_10_osc_new_cu_8a931da620osc_amps_grad_halvesILi4EEEvPKfS2_Pfiiidf",
     "osc_amps_grad_halves<4>"),
    ("_ZN43_GLOBAL__N__079cb419_10_osc_new_cu_8a931da621osc_amps_grad_combineEPKfPfiii",
     "osc_amps_grad_combine"),
    ("_ZN3tvc5mrd_fILi64ELi128EEEvv", "mrd_f<64, 128>"),
    ("_Z10foo_kernelPf", "foo_kernel"),
])
def test_build_phase_names_each_kernels_ptxas_line(mangled, name):
    """`chip_smoke.py`'s build phase prints each kernel's spills and
    registers under its name and integer template arguments, read from the
    mangled name that `-Xptxas -v` reports."""
    import chip_smoke

    assert chip_smoke._kernel_name(mangled) == name
