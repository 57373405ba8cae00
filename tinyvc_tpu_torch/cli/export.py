"""CLI: ``torch.export`` of the encoder, SourceNet and FilterNet
(counterpart of `tinyvc_tpu/cli/export.py`, which writes StableHLO).

    python -m tinyvc_tpu_torch.cli.export -o exported \\
        -encp models/two_speaker/encoder_B.npz -decp models/two_speaker/decoder_B.npz

Weights are params-only ``.npz`` exports, the reference's ``.pt`` state
dicts or the port's checkpoint directories (`utils/model_store.py`). It
writes ``encoder.pt2``, ``source_net.pt2`` and ``filter_net.pt2``
(`infer/export.py`: symbolic batch and frames, ``f >= 2``) and prints JAX's
``key: value`` lines. ``--device cuda`` (the default) exports on the card
and fails when CUDA is absent; such programs load only where there is a
card. ``--device cpu`` exports programs that load anywhere.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="export models with torch.export")
    p.add_argument("-o", "--output-dir", default="exported")
    p.add_argument("-encp", "--encoder-path", default="models/encoder")
    p.add_argument("-decp", "--decoder-path", default="models/decoder")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    from ..config import TinyVCConfig
    from ..infer.export import export_all
    from ..utils.model_store import load_decoder_params, load_encoder_params

    cfg = TinyVCConfig()
    paths = export_all(
        load_encoder_params(args.encoder_path, cfg),
        load_decoder_params(args.decoder_path, cfg),
        args.output_dir,
        cfg,
        device=args.device,
    )
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
