"""The traced run's reading: ``torch.profiler`` over a stretch of whole
requests, exported as a Chrome trace under ``TMPDIR``, read back and
deleted.

A layer's device time is the time of the device operations (kernels, copies,
memsets) whose launching runtime call (same correlation id) lies inside one
of the layer's host ranges. Busy time is the union of device operation
intervals within the stretch's window, which runs from the start of its first
request range to the end of its last.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Mapping, Sequence, Tuple

from . import counts

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CAT = "user_annotation"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")

# Kernel-name fragments -> group for the breakdown; the first match wins.
# A copy of the port's `chip_smoke.py::PROFILE_GROUPS`; cuDNN's
# convolutions are implicit GEMMs, so they are matched before plain GEMMs.
PROFILE_GROUPS = (
    ("kernel M (MRD forward)", ("mrd_fwd_",)),
    ("kernel N (MRD dy, dx)", ("mrd_dy_", "mrd_dx_")),
    ("kernel O (MRD dW, db)", ("mrd_dw_", "mrd_db_kernel")),
    ("kernel I (oscillator gradient)", ("osc_amps_grad",)),
    ("kernel A (oscillator)", ("osc_bank",)),
    ("kernel B (noise)", ("noise_fft", "noise_synth")),
    ("kernel C (upsample)", ("upsample_linear_kernel",)),
    ("kernel D (downsample)", ("downsample_linear_kernel",)),
    ("kernel E (stem, down chains)", ("down_chain_",)),
    ("kernel F (up chains)", ("up_chain_",)),
    ("kernel G (spectrogram)", ("spectrogram_fft", "spectrogram_dft")),
    ("kernel H (kNN)", ("knn_prep", "knn_topk", "knn_mean")),
    ("kernel J (resample gradients)", ("resample_grad_", "upsample_grad_kernel",
                                       "downsample_grad_kernel")),
    ("kernel K (up chain gradients)", ("up_grad_",)),
    ("kernel L (stem, down chain gradients)", ("down_grad_",)),
    ("fft", ("fft",)),
    ("convolution", ("fprop", "implicit", "conv")),
    ("gemm", ("gemm",)),
    ("host-to-device copies", ("memcpy htod",)),
)
# beyond the copy: the request's output copy, which conversion ends in
EXTRA_GROUPS = (("device-to-host copies", ("memcpy dtoh",)),)
OTHER_GROUP = "elementwise, reductions, device copies"
BREAKDOWN_ENTRIES = 10


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS + EXTRA_GROUPS:
        if any(k in low for k in keys):
            return group
    return OTHER_GROUP


def union_s(intervals: Sequence[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length, merged intervals) of ``(start, end)`` pairs."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


class Ranges:
    """Host ranges of one name, for containment tests."""

    def __init__(self, spans: Sequence[Tuple[float, float]]):
        _, merged = union_s(spans)
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def contains(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


@dataclasses.dataclass
class Trace:
    """One stretch's events (times in seconds) and what the metrics need to
    know of its requests: ``requests`` as ``(rows, padded samples)``,
    ``dictionary_rows`` and the configuration."""

    events: List[Mapping]
    requests: List[Tuple[int, int]]
    dictionary_rows: int
    cfg: Mapping

    def __post_init__(self):
        self.device = [e for e in self.events if e["cat"] in DEVICE_CATS]
        self.runtime = [e for e in self.events if e["cat"] in RUNTIME_CATS]
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in self.events:
            if e["cat"] == RANGE_CAT:
                self.ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        req = self.ranges.get("request", [])
        self.window = (min(s for s, _ in req), max(e for _, e in req)) if req else (0.0, 0.0)
        self._by_corr: Dict[int, List[Mapping]] = defaultdict(list)
        for e in self.device:
            if e.get("corr") is not None:
                self._by_corr[e["corr"]].append(e)

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _clipped(self) -> List[Tuple[float, float]]:
        a, b = self.window
        return [(max(e["ts"], a), min(e["ts"] + e["dur"], b)) for e in self.device
                if e["ts"] < b and e["ts"] + e["dur"] > a]

    def busy_s(self) -> float:
        return union_s(self._clipped())[0]

    def range_device_s(self, *names: str) -> float:
        """Device time launched inside any range of ``names``."""
        ranges = [Ranges(self.ranges[n]) for n in names if self.ranges.get(n)]
        total = 0.0
        for r in self.runtime:
            if r.get("corr") in self._by_corr and any(g.contains(r["ts"]) for g in ranges):
                total += sum(d["dur"] for d in self._by_corr[r["corr"]])
        return total

    def launches(self) -> int:
        a, b = self.window
        return sum(1 for r in self.runtime if r["name"] in LAUNCHES and a <= r["ts"] <= b)

    def layer_calls(self, layer: str) -> List[counts.Call]:
        return [c for B, L in self.requests
                for c in counts.request_layers(B, L, self.dictionary_rows, self.cfg)[layer]]

    def breakdown(self) -> Dict[str, List[List]]:
        """The device time by kernel group and the idle time within the
        window by the innermost host range the host was in meanwhile, each
        the largest ``BREAKDOWN_ENTRIES``, in seconds."""
        groups: Dict[str, float] = defaultdict(float)
        for s, e, d in ((x["ts"], x["ts"] + x["dur"], x) for x in self.device):
            if s < self.window[1] and e > self.window[0]:
                groups[group_of(d["name"])] += d["dur"]
        _, merged = union_s(self._clipped())
        a, b = self.window
        edges = [a] + [t for iv in merged for t in iv] + [b]
        spans = sorted((e - s, n, s, e) for n, v in self.ranges.items() for s, e in v)
        cuts = sorted({t for _, _, s, e in spans for t in (s, e)})
        idle: Dict[str, float] = defaultdict(float)
        for s, e in zip(edges[0::2], edges[1::2]):
            # split the gap where the host enters or leaves a range
            inside = [s] + cuts[bisect.bisect_right(cuts, s):bisect.bisect_left(cuts, e)] + [e]
            for u, v in zip(inside, inside[1:]):
                mid = 0.5 * (u + v)
                inner = next((n for _, n, rs, re in spans if rs <= mid <= re), "between requests")
                idle[inner] += v - u

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:BREAKDOWN_ENTRIES]

        return {"device_ops": top(groups), "idle_gaps": top(idle)}


def chrome_events(path: str) -> List[Dict]:
    """The complete events of an exported Chrome trace, in seconds, with
    their correlation ids."""
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    out = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        args = e.get("args") or {}
        out.append(dict(cat=e.get("cat", ""), name=e.get("name", ""), ts=float(e["ts"]) * 1e-6,
                        dur=float(e["dur"]) * 1e-6, corr=args.get("correlation")))
    return out


def profile(fn, cuda: bool = True) -> List[Dict]:
    """Run ``fn`` under ``torch.profiler`` (host and, with ``cuda``, CUDA
    activity) and return the trace's events; the trace file lives in a
    temporary directory under ``TMPDIR`` and is deleted."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return chrome_events(path)
