"""Training metrics as JSON lines (counterpart of
`tinyvc_tpu/utils/metrics.py`'s ``metrics.jsonl`` stream, with its tags:
the reference's TensorBoard layout). TensorBoard is not written."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

TAG_PITCH = "loss/Pitch Estimation"
TAG_DISTILL = "loss/Distillation"
TAG_SPEC = "loss/Spectrogram"
TAG_DSP = "loss/DSP"
TAG_FEAT = "loss/Feature Matching"
TAG_G_ADV = "loss/Generator Adversarial"
TAG_D_ADV = "loss/Discriminator Adversarial"
TAG_SKIPPED = "train/Skipped Nonfinite Steps"


class MetricsWriter:
    """Appends one ``{"step", "time", tag: value, ...}`` line per call to
    ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str = "./logs"):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
