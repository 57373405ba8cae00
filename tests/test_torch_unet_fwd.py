"""Kernels E and F (`kernels/csrc/filter_stage.cu`): what their wrappers hand
the C entries, checked without a card. Each chain's wrapper asks its entry
for the workspace's size and allocates what the entry answered, passing the
same tensors and shapes both times, in both precisions, at the serving and
pre-join shapes and at ragged widths; the stem takes none. The tile choice
(rows and positions a block) covers every output row and position once,
and the reduction's chunks take every (input channel, tap) pair once, in
the order the plain version sums them. A CUDA tensor launches the kernel
or raises. `chip_smoke.py` runs the kernels and holds them to the plain
versions on the card; the parity of the plain versions with JAX is in
`test_torch_filter_stage.py` and `test_torch_serving.py`."""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from tinyvc_tpu_torch.kernels import build
from tinyvc_tpu_torch.kernels import filter_stage as fs

META = torch.device("meta")  # shapes without storage: the wrappers only pass them on

# (name, kind, B, C or cin, co, T): one request of the serving profile
# (F=320, the two-speaker decoder's widths) at B=1 and B=8, the pre-join
# step's calls (B=16 x 2 s), and ragged widths
SERVING = [(f"{kind}-B{B}-C{C}", kind, B, C, co, T)
           for B in (1, 8)
           for kind, C, co, T in (("stem", 24, 24, 153600), ("down", 24, 48, 30720),
                                  ("down", 48, 96, 7680), ("down", 96, 192, 1920),
                                  ("down", 192, 384, 640), ("up", 384, 192, 640),
                                  ("up", 192, 96, 1920), ("up", 96, 48, 7680),
                                  ("up", 48, 24, 30720), ("fold", 24, 1, 153600))]
STEP = [("step-stem", "stem", 16, 24, 24, 48000), ("step-down_1", "down", 16, 24, 48, 9600),
        ("step-down_2", "down", 16, 48, 96, 2400), ("step-up_2", "up", 16, 96, 48, 2400),
        ("step-up_3", "up", 16, 48, 24, 9600), ("step-up_4", "fold", 16, 24, 1, 48000)]
RAGGED = [(f"{kind}-C{C}", kind, 2, C, co, 37 * 480 // 16)
          for C in (12, 17, 384)
          for kind, co in (("stem", 20), ("down", 2 * C), ("up", C // 2 + 1), ("fold", 1))]
CASES = SERVING + STEP + RAGGED


def _call(kind, B, C, co, T, dtype, device=META):
    """The kind's wrapper on tensors of ``dtype`` (weights fp32)."""
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    if kind in ("up", "fold"):
        fold = 7 if kind == "fold" else 0
        ws = [z(4, C, 3 * C), z(4, C, 1), z(4 * C, C), z(4 * C, 1), z(fold or co, C),
              z(fold or co, 1)]
        kw = dict(fold_k=7, bout=z(1, 1)) if fold else dict(out_dtype=dtype)
        return fs.upsample_chain(z(B, C, T + 3).to(dtype), z(B, C, T).to(dtype), *ws, **kw)
    if kind == "down":
        ws = [z(co, C), z(co, 1), z(C, 3 * C), z(C, 1), z(C, 3 * C), z(C, 1), z(co, 3 * C),
              z(co, 1)]
        return fs.downsample_chain(z(B, C, T + 2).to(dtype), *ws, out_len=T)
    return fs.conv3(z(B, C, T).to(dtype), z(co, 3 * C), z(co, 1))


def _on_card(monkeypatch, launch):
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(build, "launch", launch)
    for wrapper in (fs.upsample_chain, fs.downsample_chain, fs.conv3):
        for counter in ("launches", "launches_bf16"):  # other tests read them
            monkeypatch.setattr(wrapper, counter, 0)


ENTRY = {"up": "tvc_up_chain", "fold": "tvc_up_chain", "down": "tvc_down_chain",
         "stem": "tvc_conv3"}


def _nptr(name):
    """The pointer arguments of an entry before its integers (the stream last)."""
    return len([a for a in build.SIGNATURES[name] if a is ctypes.c_void_p]) - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind,B,C,co,T", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_wrapper_allocates_what_the_entry_asks(monkeypatch, kind, B, C, co, T, dtype):
    """Each chain's wrapper, its launch intercepted, reaches its entry twice:
    first with a null workspace (the entry's size query, answered here),
    then with a byte workspace of exactly the answered size, the same
    tensors and shapes; the stem's once, without a workspace."""
    calls = []
    answer = 1000003 + B * C * T  # the bytes the stand-in entry asks for

    def fake_launch(name, t, *args):
        calls.append((name, args))
        if name != "tvc_conv3" and args[_nptr(name) - 2] is None:
            args[_nptr(name) - 1]._obj.value = answer

    _on_card(monkeypatch, fake_launch)
    out = _call(kind, B, C, co, T, dtype)
    assert tuple(out.shape) == (B, co, T)
    assert out.dtype == (torch.float32 if kind == "fold" else dtype)
    name = ENTRY[kind]
    n = _nptr(name)
    bf16 = int(dtype == torch.bfloat16)
    if kind == "stem":
        assert [c[0] for c in calls] == [name]
        dims = list(calls[0][1][n:])
    else:
        assert [c[0] for c in calls] == [name] * 2
        (_, query), (_, run) = calls
        assert len(query) == len(run) == len(build.SIGNATURES[name]) - 1
        assert query[:n - 2] == run[:n - 2]  # the same tensors
        assert query[n - 2] is None
        ws = run[n - 2]
        assert ws.dtype == torch.uint8 and ws.numel() == answer
        assert list(query[n:]) == list(run[n:])
        dims = list(run[n:])
    assert dims[:4] == [B, C, co, T]
    if kind in ("up", "fold"):
        fold = 7 if kind == "fold" else 0
        assert dims[5:] == [fold, bf16, int(bool(bf16) and not fold)]
    else:
        assert dims[5:] == [bf16]


CHAIN_WIDTHS = (12, 17, 24, 48, 96, 192, 384)


@pytest.mark.parametrize("C", CHAIN_WIDTHS)
def test_tiles_cover_each_row_position_and_pair_once(C):
    """At every width the chains run (and ragged 12, 17), for the products of
    its chains (C input channels; C/2 + 1, C, 2C output rows, and one, the
    output 1x1's least): the blocks' rows cover each output row once and
    their positions each position once, and the reduction's chunks take
    each (input channel, tap) pair once, channel by channel and each
    channel's taps in order (the plain version's summation order)."""
    for co in (1, C // 2 + 1, C, 2 * C):
        for B, length in ((1, 640), (1, 153600), (16, 48000), (2, 37)):
            rows_a_block, positions = fs.conv_tile(co, length, B)
            assert rows_a_block % fs.TILE_WARPS == 0 and positions in (64, 128)
            rows = np.zeros(co, np.int32)
            for m0 in range(0, co, rows_a_block):
                rows[m0:min(m0 + rows_a_block, co)] += 1
            assert (rows == 1).all()
            pos = np.zeros(length, np.int32)
            for p0 in range(0, length, positions):
                pos[p0:min(p0 + positions, length)] += 1
            assert (pos == 1).all()
    for taps in (1, 3, 7):
        chunks = fs.conv_chunks(C, taps)
        assert [pair for chunk in chunks for pair in chunk] == [
            (i, k) for i in range(C) for k in range(taps)]
        assert all(len({i for i, _ in chunk}) <= fs.CHUNK_CHANNELS for chunk in chunks)


def test_tiles_fit_the_narrow_widths_and_fill_the_card():
    """Blocks of 24 rows: C = 24 and 48 run without empty rows. The deep
    stages at B=1 (C = 192 and 384) take 64 positions a block, for at least
    two blocks an SM of the H100 where the positions allow it; the long
    stages 128."""
    assert 24 % fs.TILE_ROWS == 0 and 48 % fs.TILE_ROWS == 0
    assert fs.conv_tile(24, 153600, 1)[1] == 128 and fs.conv_tile(48, 9600, 16)[1] == 128
    for C, T in ((384, 640), (192, 1920), (96, 7680)):
        E = T + 2 * fs.R_UP
        for lo in (1, 4, 13, 40):
            rows, positions = fs.conv_tile(C, E - 2 * lo, 1)
            blocks = -(-(E - 2 * lo) // positions) * -(-C // rows)
            assert positions == 64 or blocks >= 2 * fs.H100_SMS, (C, lo, blocks)
            assert C < 192 or positions == 64


class _Launched(RuntimeError):
    pass


@pytest.mark.parametrize("C", [12, 384])
@pytest.mark.parametrize("kind", ["stem", "down", "up", "fold"])
def test_cuda_tensors_launch_the_kernel_or_raise(monkeypatch, kind, C):
    """A bf16 tensor that is not on the CPU never reaches the plain version:
    the wrapper launches its kernel (here a stand-in that fails, as a card
    without the library would), and the failure propagates; at width 12 (a
    half-empty 24-row block and channel chunk) and 384."""
    launched = []

    def fake_launch(kernel, *args):
        launched.append(kernel)
        raise _Launched(kernel)

    _on_card(monkeypatch, fake_launch)
    for plain in ("conv3_plain", "downsample_chain_plain", "upsample_chain_plain"):
        monkeypatch.setattr(fs, plain, None)  # calling it would fail differently
    with pytest.raises(_Launched):
        _call(kind, 1, C, 1 if kind == "fold" else 8, 50, torch.bfloat16)
    assert launched == [ENTRY[kind]]


def test_chip_smoke_launch_groups_count_each_call():
    """`chip_smoke.py`'s per-launch groups of E and F: 5 launches an up chain
    (four convs, the output 1x1 or the fold), 3 a down chain, 1 the
    stem."""
    for kind, n in (("up", 5), ("fold", 5), ("down", 3), ("stem", 1)):
        groups = chip_smoke._fwd_launch_groups(kind)
        assert len(groups) == n and groups == sorted(groups)
        assert set(groups) <= set(range(len(chip_smoke.FWD_GROUPS)))
