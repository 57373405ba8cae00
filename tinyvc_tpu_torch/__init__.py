"""PyTorch/CUDA port of tinyvc_tpu for NVIDIA Hopper.

Whole-utterance voice conversion (`infer/generator.py`), with the serving
path's TPU kernels rewritten as CUDA kernels in `kernels/csrc/`. The package
imports torch, numpy and scipy only; `tinyvc_tpu` stays the reference and is
never imported here.
"""

from .config import TinyVCConfig, serving_config

__all__ = ["TinyVCConfig", "serving_config"]
