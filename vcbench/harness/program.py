"""The system under test, and the only module of the benchmark that imports
it: the port's ``VoiceConverter`` built from a configuration file, and the
profiler ranges that the traced run puts around its layers' entry points."""

from __future__ import annotations

import contextlib
import functools
from typing import Mapping

import torch

# layer range -> the module-level name of `infer/generator.py` that
# `_convert` and `decode_infer` look up at call time
GENERATOR_RANGES = {
    "spectrogram": "serving_spectrogram",
    "energy": "estimate_energy",
    "retrieval": "serving_match_features",
    "decoder": "decode_infer",
    "unet": "filter_infer",
}
ENCODER_RANGE = "encoder"
REQUEST_RANGE = "request"


def tinyvc_config(cfg: Mapping):
    """The port's ``TinyVCConfig`` of a configuration file."""
    from tinyvc_tpu_torch.config import (AudioConfig, DecoderConfig, EncoderConfig,
                                         RetrievalConfig, TinyVCConfig)

    def fields(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    return TinyVCConfig(audio=fields(AudioConfig, cfg["audio"]),
                        encoder=fields(EncoderConfig, cfg["encoder"]),
                        decoder=fields(DecoderConfig, cfg["decoder"]),
                        retrieval=fields(RetrievalConfig, cfg["retrieval"]))


def converter(cfg: Mapping, root: str, device: str):
    """The port's converter with the configuration's weights on ``device``,
    and the kernel library's build seconds (None when it was loaded from the
    checkout's build cache)."""
    from tinyvc_tpu_torch.infer.generator import VoiceConverter
    from tinyvc_tpu_torch.kernels import build
    from tinyvc_tpu_torch.utils.weights import load_npz

    if torch.device(device).type == "cuda":
        build.library()
    vc = VoiceConverter(load_npz(f"{root}/{cfg['weights']['encoder']}"),
                        load_npz(f"{root}/{cfg['weights']['decoder']}"),
                        cfg=tinyvc_config(cfg), device=device,
                        bucket_frames=cfg["bucket_frames"])
    return vc, build.build_seconds


def _ranged(name: str, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def layer_ranges(vc):
    """Wraps each layer's entry point in a profiler range of the layer's
    name for the duration, and restores them."""
    from tinyvc_tpu_torch.infer import generator

    saved = {attr: getattr(generator, attr) for attr in GENERATOR_RANGES.values()}
    for name, attr in GENERATOR_RANGES.items():
        setattr(generator, attr, _ranged(name, saved[attr]))
    vc.encoder.infer = _ranged(ENCODER_RANGE, type(vc.encoder).infer.__get__(vc.encoder))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(generator, attr, fn)
        del vc.encoder.infer
