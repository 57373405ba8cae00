"""CLI: real-time streaming conversion on the GPU (counterpart of
`tinyvc_tpu/cli/infer_streaming.py`).

    python -m tinyvc_tpu_torch.cli.infer_streaming \\
        -encp models/two_speaker/encoder_B.npz -decp models/two_speaker/decoder_B.npz \\
        -idx models/two_speaker/index_B.npy -p 11.99 --wav-in in.wav --wav-out out.wav

``--wav-in/--wav-out`` stream a file block by block through the same state
machine as live I/O (the input at any rate; channels averaged, resampled to
24 kHz). Without them, the microphone streams to the speaker through
PyAudio, which must be installed. ``--pipeline D`` keeps D blocks in
flight (D blocks more latency, the host's work hidden behind the card's).
``--device cuda`` (the default) fails when CUDA is absent; ``--device cpu``
runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="realtime inference (PyTorch/CUDA)")
    p.add_argument("-encp", "--encoder-path", default="models/encoder.npz")
    p.add_argument("-decp", "--decoder-path", default="models/decoder.npz")
    p.add_argument("-i", "--input", default=0, type=int)
    p.add_argument("-o", "--output", default=0, type=int)
    p.add_argument("-l", "--loopback", default=-1, type=int)
    p.add_argument("-idx", "--index", default="NONE")
    p.add_argument("-p", "--pitch-shift", default=0.0, type=float)
    p.add_argument("-t", "--target", default="target.wav")
    p.add_argument("-c", "--chunk", default=1920, type=int)
    p.add_argument("-ig", "--input-gain", default=0.0, type=float)
    p.add_argument("-og", "--output-gain", default=0.0, type=float)
    p.add_argument("--wav-in", default=None, help="stream from a wav file")
    p.add_argument("--wav-out", default=None, help="write streamed output here")
    p.add_argument(
        "--pipeline", default=0, type=int,
        help="dispatch depth D: D blocks in flight, D blocks more latency "
        "(0 = synchronous per block)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np

    from ..config import TinyVCConfig
    from ..infer.generator import VoiceConverter
    from ..infer.stream import StreamConverter
    from ..utils.audio_io import save_wav
    from ..utils.model_store import load_decoder_params, load_encoder_params, load_index
    from .infer import load_mono

    cfg = TinyVCConfig()
    cfg = dataclasses.replace(cfg, stream=dataclasses.replace(cfg.stream, block_size=args.chunk))
    sr = cfg.audio.sample_rate
    enc_params = load_encoder_params(args.encoder_path, cfg)
    dec_params = load_decoder_params(args.decoder_path, cfg)
    if args.index == "NONE":
        vc = VoiceConverter(enc_params, dec_params, cfg, device=args.device)
        target = vc.build_dictionary(load_mono(args.target, sr, vc.device))
    else:
        target = load_index(args.index)

    sc = StreamConverter(enc_params, dec_params, target, cfg, args.pitch_shift,
                         device=args.device)
    in_gain = 10.0 ** (args.input_gain / 20.0)
    out_gain = 10.0 ** (args.output_gain / 20.0)

    if args.wav_in is not None:
        wf = load_mono(args.wav_in, sr, sc.device)
        n_blocks = len(wf) // sc.block_size
        outs = []
        for b in range(n_blocks):
            block = (wf[b * sc.block_size:(b + 1) * sc.block_size] * in_gain).astype(np.float32)
            if args.pipeline > 0:
                got = sc.process_block_pipelined(block, depth=args.pipeline)
                if got is not None:
                    outs.append(got * out_gain)
            else:
                outs.append(sc.process_block(block) * out_gain)
        if args.pipeline > 0:
            outs.extend(o * out_gain for o in sc.drain())
        out = np.concatenate(outs) if outs else np.zeros(0, np.float32)
        if args.wav_out:
            save_wav(args.wav_out, out, sr)
            print(f"streamed {n_blocks} blocks -> {args.wav_out}")
        return

    try:
        import pyaudio
    except ImportError:
        raise SystemExit("pyaudio is not installed; use --wav-in/--wav-out for file streaming")

    audio = pyaudio.PyAudio()
    stream_input = audio.open(format=pyaudio.paInt16, rate=sr, channels=1,
                              input_device_index=args.input, input=True)
    stream_output = audio.open(format=pyaudio.paInt16, rate=sr, channels=1,
                               output_device_index=args.output, output=True)
    stream_loopback = (
        audio.open(format=pyaudio.paInt16, rate=sr, channels=1,
                   output_device_index=args.loopback, output=True)
        if args.loopback != -1 else None
    )

    print("Converting voice, Ctrl+C to stop conversion")
    while True:
        chunk = stream_input.read(args.chunk)
        block = np.frombuffer(chunk, dtype=np.int16).astype(np.float32) / 32768.0
        if args.pipeline > 0:
            out = sc.process_block_pipelined(block * in_gain, depth=args.pipeline)
            if out is None:  # the pipeline fills: emit silence
                out = np.zeros(sc.block_size, np.float32)
            out = out * out_gain
        else:
            out = sc.process_block(block * in_gain) * out_gain
        data = (np.clip(out, -1, 1) * 32768.0).astype(np.int16).tobytes()
        stream_output.write(data)
        if stream_loopback is not None:
            stream_loopback.write(data)


if __name__ == "__main__":
    main()
