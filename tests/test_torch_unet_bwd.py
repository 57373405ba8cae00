"""The bf16 route of kernels K and L (`kernels/csrc/unet_tiles.cuh`,
`filter_stage_bwd.cu`): what its wrappers compute on the host and hand the
C launchers, checked without a card. The split schedule of every weight
gradient covers each position of its range once; each bf16 wrapper asks
its entry for the workspace's size and allocates what the entry answered,
passing the same schedule and shapes both times; the CUDA-core entries keep
their fp32 workspace. `chip_smoke.py` runs the kernels
and holds them to the plain versions on the card; the parity with JAX is in
`test_torch_train_kernels.py`."""

import ctypes
import re

import numpy as np
import pytest
import torch

import chip_smoke
from tinyvc_tpu_torch.kernels import build
from tinyvc_tpu_torch.kernels import filter_stage as fs

# (name, kind, B, C or cin, co, T): the pre-join step's calls (TrainConfig(),
# B=16 x 2 s, the two-speaker decoder) and ragged ones
STEP = [("up_2", "up", 16, 96, 48, 2400), ("up_3", "up", 16, 48, 24, 9600),
        ("up_4", "fold", 16, 24, 1, 48000), ("stem", "stem", 16, 24, 24, 48000),
        ("down_1", "down", 16, 24, 48, 9600), ("down_2", "down", 16, 48, 96, 2400)]
RAGGED = [("up", 2, 96, 48, 777), ("up", 3, 48, 24, 777), ("fold", 1, 24, 1, 777),
          ("fold", 3, 24, 1, 333), ("stem", 2, 24, 24, 777), ("stem", 1, 17, 24, 333),
          ("down", 2, 24, 48, 333), ("down", 3, 48, 96, 777), ("up", 1, 8, 4, 50)]


def _products(kind, C, co, T):
    if kind in ("up", "fold"):
        return fs.up_grad_products(C, co, T, 7 if kind == "fold" else 0)
    if kind == "down":
        return fs.down_grad_products(C, co, T)
    return fs.conv3_grad_products(C, co, T)


@pytest.mark.parametrize("kind,B,C,co,T", [s[1:] for s in STEP] + RAGGED,
                         ids=[s[0] for s in STEP] + [f"{k}-B{b}-C{c}-T{t}" for k, b, c, _, t in RAGGED])
def test_split_schedule_covers_each_position_once(kind, B, C, co, T):
    """Every weight-gradient product's splits (`wgrad_split_chunks`, the
    kernel's walk) cover each position of each batch row's range exactly
    once, in chunks of at most TC_CHUNK inside one batch row; the number of
    splits is within [1, chunks] (the launcher's check) and its blocks
    within the fill target."""
    for p in _products(kind, C, co, T):
        S = fs.wgrad_splits(B, p)
        chunks = B * -(-(p.hi - p.lo) // fs.TC_CHUNK)
        assert 1 <= S <= chunks
        seen = np.zeros((B, p.hi), np.int32)
        for s in range(S):
            for b, first, end in fs.wgrad_split_chunks(B, p, s):
                assert 0 <= b < B and p.lo <= first < end <= p.hi
                assert end - first <= fs.TC_CHUNK
                seen[b, first:end] += 1
        assert (seen[:, p.lo:] == 1).all() and (seen[:, :p.lo] == 0).all(), p


def test_split_schedule_fills_the_card_at_the_step():
    """At the step's shapes each product's grid (blocks a split times its
    splits) comes near two blocks an SM of the H100 and not over."""
    for _, kind, B, C, co, T in STEP:
        for p in _products(kind, C, co, T):
            mt = fs._tc_mt(p.co)
            tiles = -(-p.co // (16 * mt)) * -(-(p.taps * fs._pad8(p.cin) // 8)
                                               // (10 if mt == 2 else 6))
            blocks = tiles * fs.wgrad_splits(B, p)
            assert fs.TC_FILL // 2 < blocks <= fs.TC_FILL, (kind, p, blocks)


def test_tile_rows_take_the_least_padding():
    """32, 48 or 64 rows a block, whichever pads the rows least (then the
    most rows): C = 24, 48, 96 and 4C."""
    assert [fs._tc_mt(r) for r in (1, 17, 24, 48, 96, 192, 384)] == [2, 2, 2, 3, 3, 4, 4]


def _fp32_floats(kind, B, C, co, T):
    """The floats the CUDA-core entries require (`tvc_*_grad`)."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    if kind in ("up", "fold"):
        E = T + 2 * (43 if kind == "fold" else 40)
        cols = max(4 * C * C + 4 * C, co * C + co, 7 * C + 1)
        return 22 * B * C * E + B * cdiv(E, fs.WGRAD_CHUNK) * cols
    if kind == "down":
        E = T + 14
        cols = max(3 * co * C + co, 3 * C * C + C)
        return 6 * B * C * E + B * cdiv(E, fs.WGRAD_CHUNK) * cols
    E = T + 2
    return B * C * E + B * cdiv(E, fs.WGRAD_CHUNK) * (3 * co * C + co)


def _call(kind, B, C, co, T, dtype):
    """The kind's wrapper on zero tensors of ``dtype`` (weights fp32)."""
    z = lambda *s: torch.zeros(s)  # noqa: E731
    if kind in ("up", "fold"):
        fold = 7 if kind == "fold" else 0
        ws = [z(4, C, 3 * C), z(4, C, 1), z(4 * C, C), z(4 * C, 1), z(fold or co, C),
              z(fold or co, 1)]
        return fs.upsample_chain_grad(z(B, C, T + 3).to(dtype), z(B, C, T).to(dtype), *ws,
                                      z(B, co, T), fold, z(1, 1) if fold else None)
    if kind == "down":
        ws = [z(co, C), z(co, 1), z(C, 3 * C), z(C, 1), z(C, 3 * C), z(C, 1), z(co, 3 * C),
              z(co, 1)]
        return fs.downsample_chain_grad(z(B, C, T + 2).to(dtype), *ws, z(B, co, T))
    return fs.conv3_grad(z(B, C, T).to(dtype), z(co, 3 * C), z(co, 1), z(B, co, T))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind,B,C,co,T", [("up", 2, 48, 24, 777), ("fold", 3, 24, 1, 333),
                                           ("down", 2, 24, 48, 777), ("stem", 1, 17, 24, 333),
                                           ("fold", 16, 24, 1, 48000)],
                         ids=["up", "fold", "down", "stem", "fold-step"])
def test_wrapper_allocates_what_the_launcher_checks(monkeypatch, kind, B, C, co, T, dtype):
    """Each wrapper, its launch intercepted: bf16 inputs reach the bf16 entry
    twice, first with a null workspace (the entry's size query, answered
    here), then with a byte workspace of exactly the answered size, the
    splits of `wgrad_splits` and the same shapes; fp32 inputs reach the
    CUDA-core entry once with the float workspace its launcher checks."""
    calls = []
    answer = 1000003 + B * C * T  # the bytes the stand-in entry asks for

    def fake_launch(name, t, *args):
        calls.append((name, args))
        nptr = len([a for a in build.SIGNATURES[name] if a is ctypes.c_void_p]) - 1
        if name.endswith("_bf16") and args[nptr - 3] is None:
            args[nptr - 2]._obj.value = answer

    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(build, "launch", fake_launch)
    for wrapper in (fs.upsample_chain_grad, fs.downsample_chain_grad, fs.conv3_grad):
        for counter in ("launches", "launches_bf16"):  # other tests read them
            monkeypatch.setattr(wrapper, counter, 0)
    _call(kind, B, C, co, T, dtype)
    entry = {"up": "tvc_up_chain_grad", "fold": "tvc_up_chain_grad",
             "down": "tvc_down_chain_grad", "stem": "tvc_conv3_grad"}[kind]
    if dtype == torch.bfloat16:
        assert [name for name, _ in calls] == [entry + "_bf16"] * 2
        nptr = len([a for a in build.SIGNATURES[entry + "_bf16"] if a is ctypes.c_void_p]) - 1
        (_, query), (_, run) = calls
        assert len(query) == len(run) == len(build.SIGNATURES[entry + "_bf16"]) - 1
        assert query[:nptr - 3] == run[:nptr - 3]  # the same tensors
        assert query[nptr - 3] is None
        ws = run[nptr - 3]
        assert ws.dtype == torch.uint8 and ws.numel() == answer
        for args in (query, run):
            splits = list(args[nptr - 1])
            assert splits == [fs.wgrad_splits(B, p) for p in _products(kind, C, co, T)]
            assert list(args[nptr:nptr + 4]) == [B, C, co, T]
        assert list(query[nptr:]) == list(run[nptr:])
    else:
        assert len(calls) == 1
        name, args = calls[0]
        nptr = len([a for a in build.SIGNATURES[name] if a is ctypes.c_void_p]) - 1
        assert name == entry
        ws, ws_len = args[nptr - 1], args[nptr]
        assert ws.dtype == torch.float32 and ws.numel() == ws_len
        assert ws_len == _fp32_floats(kind, B, C, co, T)
        assert args[-1] == fs.WGRAD_CHUNK


def test_chip_smoke_launch_groups_count_each_design():
    """`chip_smoke.py`'s per-launch groups: K 19, L 12 and 4 launches a call
    in bf16 (copies, recompute, input gradients, weight gradients, sums),
    27, 15 and 4 on the CUDA-core tiles."""
    for kind, tc, n in (("up", True, 19), ("down", True, 12), ("stem", True, 4),
                        ("up", False, 27), ("down", False, 15), ("stem", False, 4)):
        groups = chip_smoke._unet_launch_groups(kind, tc)
        assert len(groups) == n and set(groups) <= set(range(len(chip_smoke.UNET_GROUPS)))
        assert groups == sorted(groups) or not tc


def _entry_params(name):
    """The parameter names of the C entry ``name`` in `csrc/`."""
    for src in build.CSRC.glob("*.cu"):
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src.read_text(), re.S)
        if m:
            return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    raise AssertionError(f"{name} not found")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["up", "fold", "down"])
def test_wrappers_pass_pre_where_the_entry_takes_it(monkeypatch, kind, dtype):
    """The forward chains' wrappers (E, F) and the gradients' (K, L) hand
    their ``pre`` tensor to the parameter that the C entry names ``pre``,
    in every call (a size query too); without ``pre`` that parameter is
    null."""
    calls = []

    def fake_launch(name, t, *args):
        calls.append((name, args))
        params = _entry_params(name)
        if "ws_bytes" in params and args[params.index("ws")] is None:
            args[params.index("ws_bytes")]._obj.value = 64

    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(build, "launch", fake_launch)
    for wrapper in (fs.upsample_chain, fs.downsample_chain, fs.upsample_chain_grad,
                    fs.downsample_chain_grad):
        for counter in ("launches", "launches_bf16"):  # other tests read them
            monkeypatch.setattr(wrapper, counter, 0)
    B, C, co, T = 2, 8, 4, 50
    z = lambda *s: torch.zeros(s)  # noqa: E731
    if kind == "down":
        ws = [z(co, C), z(co, 1), z(C, 3 * C), z(C, 1), z(C, 3 * C), z(C, 1), z(co, 3 * C),
              z(co, 1)]
        x = z(B, C, T).to(dtype)
        pre = fs.chain_pre(x, T)
        forward = lambda p: fs.downsample_chain(x, *ws, pre=p)  # noqa: E731
        grad = lambda p: fs.downsample_chain_grad(x, *ws, z(B, co, T), p)  # noqa: E731
    else:
        fold = 7 if kind == "fold" else 0
        co = 1 if fold else co
        ws = [z(4, C, 3 * C), z(4, C, 1), z(4 * C, C), z(4 * C, 1), z(fold or co, C),
              z(fold or co, 1)]
        x = z(B, C, T).to(dtype)
        bout = z(1, 1) if fold else None
        pre = fs.chain_pre(x, T, fold)
        forward = lambda p: fs.upsample_chain(x, x, *ws, fold, bout, pre=p)  # noqa: E731
        grad = lambda p: fs.upsample_chain_grad(x, x, *ws, z(B, co, T), fold, bout,  # noqa: E731
                                                p)
    for call in (forward, grad):
        for p in (pre, None):
            calls.clear()
            call(p)
            assert calls
            for name, args in calls:
                params = _entry_params(name)
                assert len(args) == len(params) - 1  # all but the stream
                assert args[params.index("pre")] is p, name
