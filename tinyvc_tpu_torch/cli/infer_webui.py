"""CLI: Gradio web UI (counterpart of `tinyvc_tpu/cli/infer_webui.py`).

    python -m tinyvc_tpu_torch.cli.infer_webui -encp <enc> -decp <dec> [--device cpu]

It needs gradio, imported before any model is loaded, and exits with JAX's
message where gradio is not installed. The UI's conversion is
:func:`svc`, a function of the converter, so that it runs without gradio:
both inputs summed to mono, peak-normalised and resampled to 24 kHz on the
converter's device (`dsp/resample.py`); the target encoded into the kNN
dictionary; the input converted, clipped and scaled to int16.
``--device cuda`` (the default) fails when CUDA is absent.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np


def audio_to_wave(vc, cfg, input_audio) -> np.ndarray:
    """Gradio's ``(rate, samples [n] or [n, channels])`` -> mono float32
    at ``cfg.audio.sample_rate``, peak-normalised."""
    import torch

    from ..dsp.resample import resample

    sr, wf = input_audio
    wf = np.asarray(wf, dtype=np.float32)
    if wf.ndim == 2:
        wf = wf.sum(axis=1)
    wf = wf / (np.abs(wf).max() + 1e-9)
    if sr != cfg.audio.sample_rate:
        x = torch.from_numpy(wf[None]).to(vc.device)
        wf = resample(x, sr, cfg.audio.sample_rate)[0].cpu().numpy()
    return wf


def svc(vc, cfg, input_audio, target_audio, pitch_shift):
    """Convert ``input_audio`` to the voice of ``target_audio`` -> Gradio's
    ``(rate, int16 samples)``."""
    wf = audio_to_wave(vc, cfg, input_audio)
    target = vc.build_dictionary(audio_to_wave(vc, cfg, target_audio))
    out = np.clip(vc.convert(wf, target, pitch_shift), -1.0, 1.0)
    return (cfg.audio.sample_rate, (out * 32768.0).astype(np.int16))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-encp", "--encoder-path", default="models/encoder")
    p.add_argument("-decp", "--decoder-path", default="models/decoder")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed in this environment")

    from ..config import TinyVCConfig
    from ..infer.generator import VoiceConverter
    from ..utils.model_store import load_decoder_params, load_encoder_params

    cfg = TinyVCConfig()
    vc = VoiceConverter(load_encoder_params(args.encoder_path, cfg),
                        load_decoder_params(args.decoder_path, cfg), cfg, device=args.device)
    demo = gr.Interface(
        functools.partial(svc, vc, cfg),
        inputs=[
            gr.Audio(label="Input"),
            gr.Audio(label="Target"),
            gr.Slider(-24.0, 24.0, 0.0, label="Pitch Shift"),
        ],
        outputs=[gr.Audio()],
    )
    demo.launch()


if __name__ == "__main__":
    main()
