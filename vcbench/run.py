#!/usr/bin/env python3
"""Run one cell of `BENCHMARK.json` once, on the card this process sees.

    python3 vcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up loads the configuration's weights into the port's ``VoiceConverter``
(the kernel library from the checkout's build cache, built there on a first
run), makes the traffic and the target speaker's audio from ``--seed``,
builds the kNN dictionary on the device and warms every bucket shape of the
traffic. With ``--trace 0`` a closed loop then converts requests for
``--seconds`` and the result carries the cell's end-to-end metrics; with
``--trace 1`` the profiler covers a fixed stretch of requests, with a range
around each layer's entry point, and the result carries the per-layer
metrics. Either way, a sample of the requests is then judged against the
plain reference (`vcbench/harness/judge.py`) and the last line of standard
output is the result as one JSON object. Progress and the compared numbers
go to standard error, the compared numbers last.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")  # keep a library that the port may load off JAX
os.environ.setdefault("USE_TF", "0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vcbench.harness import cells, judge, program, trace, traffic  # noqa: E402
from vcbench.reference import model as reference  # noqa: E402
from vcbench.reference import prng  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tinyvc_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _window(vc, tr, dictionary, seconds: float, keep):
    """The closed loop: requests back to back for ``seconds``. Returns
    (latencies s, audio s, window s, failed, outputs of ``keep``)."""
    latencies, audio, failed, outs = [], 0.0, 0, {}
    gc.collect()
    gc.disable()
    try:
        t0 = end = time.perf_counter()
        i = 0
        while end - t0 < seconds:
            r = tr.request(i)
            start = time.perf_counter()
            try:
                out = vc.convert(r.wave, dictionary, r.pitch_shift, seed=r.seed)
            except Exception:  # counted as failed; the loop goes on
                traceback.print_exc()
                failed, out = failed + 1, None
            end = time.perf_counter()
            latencies.append(end - start)
            audio += r.wave.shape[0] * r.length / tr.sample_rate
            if i in keep:
                outs[i] = out
            i += 1
    finally:
        gc.enable()
    return latencies, audio, end - t0, failed, outs


def end_to_end(latencies, audio_s: float, window_s: float, setup_s: float):
    """The end-to-end metrics of a window: the audio seconds converted over
    its seconds, the 95th percentile of every request's latency (linear
    between order statistics), the set-up."""
    return {"audio_s_per_s": audio_s / window_s,
            "request_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
            "setup_s": setup_s}


def _traced(vc, tr, dictionary, requests, keep, cuda: bool):
    """The traced stretch: ``requests`` under the profiler with the layer
    ranges. Returns (events, outputs of ``keep``)."""
    outs = {}

    def stretch():
        with program.layer_ranges(vc):
            for r in requests:
                with torch.profiler.record_function(program.REQUEST_RANGE):
                    out = vc.convert(r.wave, dictionary, r.pitch_shift, seed=r.seed)
                if r.index in keep:
                    outs[r.index] = out

    return trace.profile(stretch, cuda), outs


def _rerun(vc, dictionary, requests, outs):
    """The sampled requests once more through ``convert`` with ``stages``:
    (their stages, the largest difference from the window's outputs)."""
    staged, gap = [], 0.0
    for r in requests:
        st = {}
        out = vc.convert(r.wave, dictionary, r.pitch_shift, seed=r.seed, stages=st)
        want = outs.get(r.index)
        gap = max(gap, float("inf") if want is None or want.shape != out.shape
                  else float(np.abs(out - want).max()))
        staged.append({k: st[k] for k in judge.STAGES})
    return staged, gap


def check(cfg, tr, requests, staged, outs, rerun_gap: float, device: str, root: str):
    """The compared numbers of the sampled requests, each worst over them."""
    ref = reference.Reference(cfg, root, device)
    ref_dictionary = ref.dictionary(tr.target)
    readings = [judge.compare(ref, ref_dictionary, r.wave, r.pitch_shift,
                              prng.kernel_b_seed(r.seed), st, outs[r.index])
                for r, st in zip(requests, staged) if outs.get(r.index) is not None]
    numbers = judge.worst_of(readings) if readings else {n: float("inf") for n in judge.NUMBERS}
    numbers["rerun"] = rerun_gap
    return {n: numbers[n] for n in judge.NUMBERS}


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float = T_START):
    """One run of ``cell``; returns the result object."""
    cfg, params, root = cell.config, cell.traffic, cell.root
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    vc, build_s = program.converter(cfg, root, device)
    if cuda:
        log(f"kernel library: {'built in %.1f s' % build_s if build_s else 'from the build cache'}")
    tr = traffic.make(params, seed, cfg["audio"], device)
    dictionary = vc.build_dictionary(tr.target)
    pool, sample = judge.sampled_requests(tr, params, seed)
    hop, bucket_frames = cfg["audio"]["hop_size"], cfg["bucket_frames"]
    warm = tr.warm_requests(hop, bucket_frames)
    for r in warm:
        vc.convert(r.wave, dictionary, r.pitch_shift, seed=r.seed)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: dictionary {tuple(dictionary.shape)}, {len(warm)} shapes warmed")

    metrics, dev, breakdown, failed = {}, {}, None, 0
    if not traced:
        latencies, audio, window_s, failed, outs = _window(vc, tr, dictionary, seconds, sample)
        attempted = len(latencies)
        values = end_to_end(latencies, audio, window_s, setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        log(f"window {window_s:.3f} s: {attempted} requests, {audio:.1f} audio-s, "
            f"median {1e3 * float(np.median(latencies)):.3f} ms")
    else:
        events, outs = _traced(vc, tr, dictionary, pool, sample, cuda)
        attempted = len(pool)
        tt = trace.Trace(events, [(r.wave.shape[0], traffic.bucket(r.length, hop, bucket_frames))
                                  for r in pool], dictionary.shape[0], cfg)
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"], root)(tt)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"busy_s": tt.busy_s(), "window_s": tt.window_s}
        breakdown = tt.breakdown()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    requests = [pool[i] for i in sample]
    staged, gap = _rerun(vc, dictionary, requests, outs)
    del vc, dictionary
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check(cfg, tr, requests, staged, outs, gap, device, root)
    limits = cfg.get("limits", {})
    correct = failed == 0 and judge.verdict(numbers, limits)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(peak), **dev}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # the part of set-up that built the kernel library (a checkout's first run)
    result["build_s"] = float(build_s or 0.0)
    result["checks"] = {n: {"value": v, "limit": limits.get(n)} for n, v in numbers.items()}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(2)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    for n, c in result["checks"].items():
        log(f"check {n}: {c['value']:.6g} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
