"""CLI: batch file conversion on the GPU (counterpart of
`tinyvc_tpu/cli/infer.py`).

    python -m tinyvc_tpu_torch.cli.infer -i inputs/ -o outputs/ \\
        -encp models/two_speaker/encoder_B.npz -decp models/two_speaker/decoder_B.npz \\
        -idx models/two_speaker/index_B.npy -p 11.99 [-c 512]

Inputs are the ``.wav``, ``.ogg`` and ``.mp3`` files of ``-i`` (the last two
through ffmpeg), at any rate and channel count: channels are averaged, and
the target and every input not at 24 kHz are resampled on the converter's
device (`dsp/resample.py`). Weights are params-only ``.npz`` exports or the
reference's ``.pt`` state dicts; the index a ``.npy`` ``[N, C]`` or the
reference's ``index.pt``; with ``-idx NONE`` the dictionary is encoded from
the ``-t`` target. ``--device cuda`` (the default) fails when CUDA is
absent; ``--device cpu`` runs the kernels' plain versions.

``-c N`` (N > 0) converts each file in overlap-save chunks of N frames
(`VoiceConverter.convert_chunked`, `parallel/time_shard.py`): the chunks run
as one batch with halo context, GRN statistics summed over them, the
harmonic phase seeded across each join and the noise phases drawn per
global frame, so the output agrees with whole-utterance conversion at the
mel level, not at the waveform. It pays for the halos (a 512-frame chunk
converts 704 frames) and bounds the shapes a request runs at. The default
0 converts each utterance whole.
"""

from __future__ import annotations

import argparse
import glob
import os


def load_mono(path: str, sample_rate: int, device):
    """A file's channels averaged, resampled to ``sample_rate`` on
    ``device`` when its rate differs -> ``[L]`` float32 numpy."""
    import torch

    from ..dsp.resample import resample
    from ..utils.audio_io import load_audio

    wave, sr = load_audio(path)
    wave = wave.mean(axis=0)
    if sr != sample_rate:
        x = torch.from_numpy(wave[None]).to(device)
        wave = resample(x, sr, sample_rate)[0].cpu().numpy()
    return wave


def main(argv=None):
    p = argparse.ArgumentParser(description="batch voice conversion (PyTorch/CUDA)")
    p.add_argument("-i", "--inputs", default="./inputs/")
    p.add_argument("-o", "--outputs", default="./outputs/")
    p.add_argument("-encp", "--encoder-path", default="models/encoder.npz")
    p.add_argument("-decp", "--decoder-path", default="models/decoder.npz")
    p.add_argument("-idx", "--index", default="NONE")
    p.add_argument("-t", "--target", default="target.wav")
    p.add_argument("-p", "--pitch-shift", default=0.0, type=float)
    p.add_argument("-c", "--chunk-frames", default=0, type=int,
                   help="0 = whole-utterance; N>0 = overlap-save chunked conversion in N-frame "
                   "chunks (halo recompute; agrees with whole-utterance at the mel level)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..config import TinyVCConfig
    from ..infer.generator import VoiceConverter
    from ..utils.audio_io import save_wav
    from ..utils.model_store import load_decoder_params, load_encoder_params, load_index

    cfg = TinyVCConfig()
    sr = cfg.audio.sample_rate
    vc = VoiceConverter(load_encoder_params(args.encoder_path, cfg),
                        load_decoder_params(args.decoder_path, cfg), cfg, device=args.device)
    if args.index == "NONE":
        target = vc.build_dictionary(load_mono(args.target, sr, vc.device))
    else:
        # moved to the device once, not with every file
        target = torch.from_numpy(load_index(args.index)).to(vc.device)

    os.makedirs(args.outputs, exist_ok=True)
    paths = []
    for fmt in ("wav", "ogg", "mp3"):
        paths += sorted(glob.glob(os.path.join(args.inputs, f"*.{fmt}")))
    for path in paths:
        print(f"Converting {path} ...")
        wave = load_mono(path, sr, vc.device)
        if args.chunk_frames > 0:
            out = vc.convert_chunked(wave, target, args.pitch_shift,
                                     chunk_frames=args.chunk_frames)
        else:
            out = vc.convert(wave, target, args.pitch_shift)
        name = os.path.splitext(os.path.basename(path))[0]
        save_wav(os.path.join(args.outputs, f"{name}.wav"), out, sr)
    print(f"done: {len(paths)} files -> {args.outputs}")


if __name__ == "__main__":
    main()
