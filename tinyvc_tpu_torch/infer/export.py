"""Model export with ``torch.export`` (counterpart of
`tinyvc_tpu/infer/export.py`, which writes StableHLO).

The model splits into JAX's three programs, with the DSP stage (the
oscillators and the filtered noise) outside them, as in the reference's
ONNX export:

- ``encoder``:    spec ``[b, f, 961]``                      -> (content, f0 logits)
- ``source_net``: (content ``[b, f, C]``, f0 ``[b, f]``,
  energy ``[b, hop*f]``)                                    -> (amps, kernel)
- ``filter_net``: (content, f0, energy, source
  ``[b, hop*f, H+2]``, channels-last as JAX exports it)     -> waveform ``[b, hop*f]``

Inputs are fp32; the modules compute inside in the config's dtypes. The
batch ``b`` and the frame count ``f`` are symbolic (``torch.export.Dim``)
and the sample axes take ``hop * f``. The programs hold ATen operations
only, as JAX's hold no Pallas call: the layer-by-layer U-Net, not the fused
one, so a ``.pt2`` loads in any PyTorch without this package's kernels.
Each program is ``torch.export.save``d as ``<name>.pt2``; a program
exported on the card keeps its weights there and loads only where there is
one.

The one difference from JAX: the programs take ``f >= MIN_FRAMES`` (3),
JAX's ``f >= 1``. ``torch.export`` specialises a size of 1 wherever a
reshape or a slice produces it. SourceNet's per-frame energy
(``energy.reshape(b, f, hop)``) refuses ``f = 1``; the U-Net's linear
upsampling at the frame-rate stage (`dsp/interp.py::upsample_time_int_t`)
slices ``f - 1`` frames for each sample's neighbours and refuses ``f = 2``
(the guard ``f - 1 != 1``). Slicing otherwise (padding the input once)
would lift that, but it reorders the sums of the training step's gradient
and so moves its AdamW step (`tests/test_torch_train_postjoin.py`), so the
programs take one frame more instead.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict

import torch
from torch import nn
from torch.export import Dim

from ..config import TinyVCConfig
from ..utils.weights import decoder_from_jax, encoder_from_jax
from .generator import _resolve_device, exact_fp32

MIN_FRAMES = 3
EXAMPLE_BATCH = 2  # an example batch of 1 would specialise b to 1


class _SourceNet(nn.Module):
    def __init__(self, decoder: nn.Module):
        super().__init__()
        self.source_net = decoder.source_net

    def forward(self, content, f0, energy):
        return self.source_net(content, f0, energy)


class _FilterNet(nn.Module):
    """The U-Net on a channels-last source ``[b, hop*f, H+2]``."""

    def __init__(self, decoder: nn.Module):
        super().__init__()
        self.filter_net = decoder.filter_net

    def forward(self, content, f0, energy, source):
        return self.filter_net(content, f0, energy, source.transpose(1, 2))


def export_all(
    enc_params: Dict[str, Any],
    dec_params: Dict[str, Any],
    output_dir: str,
    cfg: TinyVCConfig | None = None,
    example_frames: int = 100,
    device: str | torch.device = "cuda",
) -> Dict[str, str]:
    """Export the three programs of the JAX parameter trees ``enc_params``
    and ``dec_params`` into ``output_dir`` -> ``{"encoder", "source_net",
    "filter_net": path, "symbolic": "True"}``. The example inputs are
    ``EXAMPLE_BATCH`` rows of ``example_frames`` frames on ``device`` (CUDA
    by default; it raises without a card). A failed export raises."""
    cfg = cfg or TinyVCConfig()
    if example_frames < MIN_FRAMES:
        raise ValueError(f"example_frames must be at least {MIN_FRAMES}, got {example_frames}")
    device = _resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    encoder = encoder_from_jax(enc_params, cfg.encoder).to(device)
    decoder = decoder_from_jax(dec_params, cfg.decoder, cfg.audio).to(device)
    hop = cfg.audio.hop_size
    B, F = EXAMPLE_BATCH, example_frames
    b, f = Dim("b"), Dim("f", min=MIN_FRAMES)
    frames, samples = {0: b, 1: f}, {0: b, 1: hop * f}
    dc = cfg.decoder

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    content, f0, energy = zeros(B, F, dc.content_channels), zeros(B, F), zeros(B, F * hop)
    programs = {
        "encoder": (encoder, (zeros(B, F, cfg.audio.fft_bin),), {"spec": frames}),
        "source_net": (_SourceNet(decoder), (content, f0, energy),
                       {"content": frames, "f0": frames, "energy": samples}),
        "filter_net": (_FilterNet(decoder),
                       (content, f0, energy, zeros(B, F * hop, dc.num_harmonics + 2)),
                       {"content": frames, "f0": frames, "energy": samples,
                        "source": samples}),
    }
    paths = {}
    for name, (module, args, dynamic_shapes) in programs.items():
        program = torch.export.export(module.eval(), args, dynamic_shapes=dynamic_shapes)
        paths[name] = os.path.join(output_dir, f"{name}.pt2")
        torch.export.save(program, paths[name])
    paths["symbolic"] = "True"
    return paths


class ExportedCallable:
    """A loaded program: call it with tensors (or arrays) on any device;
    they move to the program's device. It runs under inference mode, and on
    CUDA with TF32 off (`infer/generator.py::exact_fp32`): TF32 is a run-time
    flag that the exported convolutions obey."""

    def __init__(self, module: nn.Module, device: torch.device):
        self.module, self.device = module, device

    def __call__(self, *args):
        args = tuple(torch.as_tensor(a).to(self.device) for a in args)
        precision = exact_fp32() if self.device.type == "cuda" else contextlib.nullcontext()
        with torch.inference_mode(), precision:
            return self.module(*args)


def _program_device(program) -> torch.device:
    for t in list(program.state_dict.values()) + list(program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def load_exported(path: str, device: str | torch.device | None = None) -> ExportedCallable:
    """A ``.pt2`` of :func:`export_all` -> a callable over
    ``torch.export.load(path).module()``. ``device`` None keeps the program
    where it was exported; another device moves its weights and the devices
    written into its graph (``torch.export.passes.move_to_device_pass``)."""
    program = torch.export.load(path)
    if device is not None:
        device, here = _resolve_device(device), _program_device(program)
        if device.type != here.type or device.index not in (None, here.index):
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, device)
    return ExportedCallable(program.module(), _program_device(program))
