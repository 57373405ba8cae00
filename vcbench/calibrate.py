#!/usr/bin/env python3
"""The readings that the limits of the comparison are set from, on the card.

    python3 vcbench/calibrate.py --workload <name> --seeds 12 --control-seeds 3 \
        [--seconds 2] [--first-seed N] [--out FILE]

For each of ``--seeds`` seeds, one run of the cell with a short window at the
cell's own load (`run.py`'s ``run_cell``): the program's numbers. Then, for
``--control-seeds`` seeds, the control: the plain reference computed in the
precision just below the configuration's (TF32 for its fp32 products, fp8
e4m3 for its bf16 ones; the matched frames' rows in the decoder's dtype's
control) put in the program's place on the same sampled
requests, judged by the same numbers. All in one process; one JSON line a
reading on standard output (and appended to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from vcbench import run  # noqa: E402
from vcbench.harness import cells, judge, traffic  # noqa: E402
from vcbench.reference import model as reference  # noqa: E402
from vcbench.reference import prng  # noqa: E402


def control_numbers(cell: cells.Cell, seed: int, device: str):
    """The control's numbers on ``seed``'s sampled requests."""
    cfg, params, root = cell.config, cell.traffic, cell.root
    tr = traffic.make(params, seed, cfg["audio"], device)
    pool, sample = judge.sampled_requests(tr, params, seed)
    ref = reference.Reference(cfg, root, device)
    prec = reference.Precision.control(cfg["decoder"]["compute_dtype"])
    ctl_dictionary = ref.dictionary(tr.target, prec)
    ref_dictionary = ref.dictionary(tr.target)
    readings = []
    for i in sample:
        r = pool[i]
        padded = reference.bucket_pad(r.wave, ref.hop, cfg["bucket_frames"])
        noise_seed = prng.kernel_b_seed(r.seed)
        blocks = [ref.convert(padded[b:b + judge.ROWS_PER_BLOCK], ctl_dictionary, r.pitch_shift,
                              noise_seed, prec, row0=b)
                  for b in range(0, len(padded), judge.ROWS_PER_BLOCK)]
        stages = {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}
        out = stages.pop("out")[:, :r.length].float().cpu().numpy()
        readings.append(judge.compare(ref, ref_dictionary, r.wave, r.pitch_shift, noise_seed,
                                      stages, out))
    return judge.worst_of(readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2

    def emit(kind, seed, numbers, seconds):
        line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                           "seconds": round(seconds, 3), "numbers": numbers})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        result = run.run_cell(cell, seed, args.seconds, False, "cuda", t0)
        emit("program", seed, {n: c["value"] for n, c in result["checks"].items()},
             time.perf_counter() - t0)
    for k in range(args.control_seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        emit("control", seed, control_numbers(cell, seed, "cuda"), time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
