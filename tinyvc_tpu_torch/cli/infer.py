"""CLI: batch file conversion on the GPU (counterpart of
`tinyvc_tpu/cli/infer.py`, whole-utterance mode).

    python -m tinyvc_tpu_torch.cli.infer -i inputs/ -o outputs/ \\
        -encp models/two_speaker/encoder_B.npz -decp models/two_speaker/decoder_B.npz \\
        -idx models/two_speaker/index_B.npy -p 11.99

Weights are params-only ``.npz`` exports, the index a ``.npy`` ``[N, C]``;
with ``-idx NONE`` the dictionary is encoded from the ``-t`` target wav.
Inputs are 24 kHz ``.wav`` files. ``--device cuda`` (the default) fails when
CUDA is absent; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="batch voice conversion (PyTorch/CUDA)")
    p.add_argument("-i", "--inputs", default="./inputs/")
    p.add_argument("-o", "--outputs", default="./outputs/")
    p.add_argument("-encp", "--encoder-path", default="models/encoder.npz")
    p.add_argument("-decp", "--decoder-path", default="models/decoder.npz")
    p.add_argument("-idx", "--index", default="NONE")
    p.add_argument("-t", "--target", default="target.wav")
    p.add_argument("-p", "--pitch-shift", default=0.0, type=float)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..infer.generator import VoiceConverter
    from ..utils.audio_io import load_audio, save_wav
    from ..utils.weights import load_index, load_npz

    vc = VoiceConverter(
        load_npz(args.encoder_path), load_npz(args.decoder_path), device=args.device
    )
    if args.index == "NONE":
        target = vc.build_dictionary(load_audio(args.target))
    else:
        # moved to the device once, not with every file
        target = torch.from_numpy(load_index(args.index)).to(vc.device)

    os.makedirs(args.outputs, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.inputs, "*.wav")))
    for path in paths:
        print(f"Converting {path} ...")
        out = vc.convert(load_audio(path), target, args.pitch_shift)
        name = os.path.splitext(os.path.basename(path))[0]
        save_wav(os.path.join(args.outputs, f"{name}.wav"), out)
    print(f"done: {len(paths)} files -> {args.outputs}")


if __name__ == "__main__":
    main()
