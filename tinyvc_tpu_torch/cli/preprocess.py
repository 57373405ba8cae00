"""CLI: audio files -> the training cache (counterpart of
`tinyvc_tpu/cli/preprocess.py`).

    python -m tinyvc_tpu_torch.cli.preprocess <raw dir> -o dataset_cache

Every ``mp3``/``wav``/``ogg`` under the directory is mixed to mono,
resampled to 24 kHz and cut into ``-len`` sample chunks, written as
``{i}.wav`` with their f0 labels ``{i}.f0.npy`` (batched YIN, ``--f0-batch``
chunks a call). ``--device cuda`` (the default) fails when CUDA is absent;
``--device cpu`` runs on the CPU.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="preprocess audio into the dataset cache")
    p.add_argument("input")
    p.add_argument("-o", "--output", "--dataset-cache", default="dataset_cache")
    p.add_argument("-len", "--length", default=48000, type=int)
    p.add_argument("-m", "--max-files", default=-1, type=int)
    p.add_argument("--f0-estimation", default="yin", choices=["yin", "dio", "harvest", "fcpe"],
                   help="'yin' is the batched estimator on the device; others need extra deps")
    p.add_argument("--f0-batch", default=64, type=int)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    from ..data.preprocess import preprocess

    n = preprocess(args.input, args.output, length=args.length, max_files=args.max_files,
                   f0_algorithm=args.f0_estimation, f0_batch=args.f0_batch, device=args.device)
    print(f"complete! cached {n} chunks under {args.output}")


if __name__ == "__main__":
    main()
