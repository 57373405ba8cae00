"""CLI: export params-only ``.npz`` serving checkpoints (counterpart of
`tinyvc_tpu/cli/export_params.py`).

The port's training checkpoints (`utils/checkpoint.py`: ``<dir>/<step>/
state.pt``) carry the whole train state: parameters, AdamW's moments and
the step, and the decoder's the discriminator too. Serving needs only the
encoder's and the generator's parameters. This writes them in the format
that both packages' ``utils/model_store`` load wherever a checkpoint path
is accepted (``cli/infer -encp enc.npz -decp dec.npz``): a voice trained on
the port goes to the JAX package this way.

    python -m tinyvc_tpu_torch.cli.export_params \\
        -encp <encoder checkpoint dir> -decp <decoder checkpoint dir> \\
        -o-enc voice_encoder.npz -o-dec voice_decoder.npz

``-encp``/``-decp`` also take ``.npz`` and the reference's ``.pt``; the JAX
package's orbax directories need JAX and are refused
(`utils/model_store.py`).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="export params-only serving .npz")
    p.add_argument("-encp", "--encoder-path", default=None,
                   help="the port's encoder checkpoint dir (or .npz, .pt)")
    p.add_argument("-decp", "--decoder-path", default=None,
                   help="the port's decoder checkpoint dir (or .npz, .pt)")
    p.add_argument("-o-enc", "--out-encoder", default="encoder_params.npz")
    p.add_argument("-o-dec", "--out-decoder", default="decoder_params.npz")
    args = p.parse_args(argv)

    from ..config import TinyVCConfig
    from ..utils.model_store import load_decoder_params, load_encoder_params, save_params_npz

    cfg = TinyVCConfig()
    if args.encoder_path:
        params = load_encoder_params(args.encoder_path, cfg)
        save_params_npz(args.out_encoder, params)
        print(f"encoder params -> {args.out_encoder}")
    if args.decoder_path:
        params = load_decoder_params(args.decoder_path, cfg)
        save_params_npz(args.out_decoder, params)
        print(f"decoder generator params -> {args.out_decoder}")
    if not (args.encoder_path or args.decoder_path):
        raise SystemExit("nothing to export: pass -encp and/or -decp")


if __name__ == "__main__":
    main()
