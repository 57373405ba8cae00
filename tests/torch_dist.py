"""Launching `tests/torch_dist_worker.py`: one subprocess a rank of a gloo
group on this machine, each bounded by a timeout, and reading back what the
ranks wrote."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
ENV = {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2", "TINYVC_NO_NATIVE_LOADER": "1",
       "HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def flat(tree, prefix=""):
    """A nested tree of arrays as flat '/'-joined keys under ``prefix``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def launch(directory, cases, inputs=None, world=2, timeout=120):
    """Write ``cases`` (and each case's ``inputs[name]``) under
    ``directory``, run ``world`` ranks on a free port and wait for all of
    them, at most ``timeout`` seconds in all (every rank still running then
    is killed). -> [(returncode, stdout, stderr)] by rank."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "cases.json"), "w") as f:
        json.dump(cases, f)
    for name, arrays in (inputs or {}).items():
        np.savez(os.path.join(directory, f"{name}.npz"), **arrays)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(directory), str(r), str(world),
                               str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=directory, env={**os.environ, **ENV})
             for r in range(world)]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def run(directory, cases, inputs=None, world=2, timeout=120):
    """:func:`launch`, every rank required to succeed; -> each case's
    outputs by rank, ``{name: [rank 0's dict, rank 1's, ...]}``."""
    results = launch(directory, cases, inputs, world, timeout)
    for r, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {r} exited {code}:\n{out[-2000:]}\n{err[-4000:]}"
    return {c["name"]: [dict(np.load(os.path.join(directory, f"{c['name']}.{r}.npz")))
                        for r in range(world)] for c in cases}
