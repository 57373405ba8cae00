"""What a run loads: the harness and the reference load nothing of JAX or
the JAX package, and the reference nothing of the program either. Each
check runs in a fresh interpreter, compared by whole top-level names."""

import json
import os
import subprocess
import sys

from vcbench.harness import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tinyvc_tpu"}

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from vcbench import run
from vcbench.conftest import SMALL_TRAFFIC
from vcbench.harness import cells
cell = cells.resolve("convert-serving-dict4k")
cell.config["decoder"]["use_fused_filter"] = "on"
cell.traffic.update(SMALL_TRAFFIC)
run.run_cell(cell, 7, 0.5, True, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
from vcbench.harness import cells
from vcbench.reference import model
cfg = cells.load_json({root!r} + "/vcbench/configs/tinyvc-serving.json")
r = model.Reference(cfg, {root!r}, "cpu")
wave = model.bucket_pad(np.random.default_rng(0).standard_normal((1, 9000)) * 0.1, 480, 64)
st = r.convert(wave, r.dictionary(wave[:, :30720]), 0.0, 5)
assert st["out"].shape == wave.shape
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code.format(root=cells.ROOT)], env=env,
                         capture_output=True, text=True, timeout=600, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _modules(RUN)
    assert "tinyvc_tpu_torch" in loaded  # the program under test
    assert not loaded & FORBIDDEN


def test_the_reference_loads_neither_jax_nor_the_program():
    loaded = _modules(REFERENCE)
    assert not loaded & (FORBIDDEN | {"tinyvc_tpu_torch"})
