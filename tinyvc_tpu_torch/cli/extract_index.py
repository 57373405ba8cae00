"""CLI: kNN dictionary extraction (counterpart of
`tinyvc_tpu/cli/extract_index.py`).

    python -m tinyvc_tpu_torch.cli.extract_index --dataset-cache <dir> \\
        -encp models/two_speaker/encoder_B.npz -o index.npy [--device cpu]

The cache holds ``{i}.wav`` (24 kHz, one length) and ``{i}.f0.npy`` files;
the output is a ``[N, C]`` float32 ``.npy`` for ``cli.infer -idx``.
``--device cuda`` (the default) fails when CUDA is absent.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="extract kNN speaker index (PyTorch/CUDA)")
    p.add_argument("--dataset-cache", default="dataset_cache")
    p.add_argument("-encp", "--encoder-path", default="models/encoder.npz")
    p.add_argument("-size", default=2048, type=int)
    p.add_argument("-o", "--output", default="models/index.npy")
    p.add_argument("--stride", default=4, type=int)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import numpy as np

    from ..config import TinyVCConfig
    from ..infer.index import extract_index
    from ..utils.model_store import load_encoder_params

    cfg = TinyVCConfig()
    index = extract_index(load_encoder_params(args.encoder_path, cfg), args.dataset_cache,
                          size=args.size, stride=args.stride, cfg=cfg, device=args.device)
    np.save(args.output, index)
    print(f"extracted {index.shape[0]} vectors -> {args.output}")


if __name__ == "__main__":
    main()
