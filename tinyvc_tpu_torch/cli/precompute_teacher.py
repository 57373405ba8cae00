"""CLI: teacher features into the training cache (counterpart of
`tinyvc_tpu/cli/precompute_teacher.py`).

    python -m tinyvc_tpu_torch.cli.precompute_teacher --dataset-cache dataset_cache \\
        --backend mfcc

Writes ``{idx}.teacher.npy`` beside every chunk of the cache, computed from
the clean chunk; `train/teacher.py::make_teacher` then prefers them.
``--backend mfcc`` is the procedural teacher (`train/teacher.py::
MFCCTeacher`, numpy on the host, at 24 kHz); ``--backend wavlm`` needs
``transformers`` and the WavLM-Base+ weights, and stops with the JAX
package's message when they cannot be loaded.
"""

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        description="precompute WavLM layer-4 teacher features for distillation")
    p.add_argument("--dataset-cache", default="dataset_cache")
    p.add_argument("--backend", default="wavlm", choices=["wavlm", "mfcc"],
                   help="'wavlm' = frozen WavLM-Base+ (needs transformers + weights); "
                   "'mfcc' = procedural speaker-normalised MFCC teacher (numpy only, "
                   "needs no download; see train/teacher.py::MFCCTeacher)")
    p.add_argument("--wavlm", default="microsoft/wavlm-base-plus")
    p.add_argument("--layer", type=int, default=4)
    p.add_argument("-b", "--batch-size", type=int, default=16)
    p.add_argument("--overwrite", action="store_true",
                   help="recompute even if {idx}.teacher.npy already exists")
    args = p.parse_args(argv)

    from ..data.dataset import Dataset

    ds = Dataset(args.dataset_cache)
    if args.backend == "mfcc":
        from ..train.teacher import MFCCTeacher

        teacher = MFCCTeacher()
        to_teacher_input = lambda waves: waves  # native 24 kHz  # noqa: E731
    else:
        import torch

        from ..config import TinyVCConfig
        from ..dsp.resample import resample
        from ..train.teacher import WavLMTeacher

        cfg = TinyVCConfig()
        try:
            teacher = WavLMTeacher(args.wavlm, layer=args.layer)
        except Exception as e:
            raise SystemExit(
                f"could not load the WavLM teacher {args.wavlm!r} "
                f"({type(e).__name__}: {e}).\nIn offline environments, download "
                "the weights elsewhere and point --wavlm at a local directory, "
                "copy precomputed {idx}.teacher.npy files into the cache, or "
                "use --backend mfcc (procedural, no downloads).")

        def to_teacher_input(waves):
            return resample(torch.from_numpy(waves), cfg.audio.sample_rate, 16000).numpy()

    todo = [i for i in range(len(ds))
            if args.overwrite
            or not os.path.exists(os.path.join(args.dataset_cache, f"{i}.teacher.npy"))]
    print(f"precomputing {args.backend} teacher features for {len(todo)}/{len(ds)} chunks")
    for lo in range(0, len(todo), args.batch_size):
        idxs = todo[lo: lo + args.batch_size]
        waves = np.stack([ds[i][0] for i in idxs])  # [b, L] clean 24 kHz
        feats = teacher(to_teacher_input(waves))  # [b, Ft, 768]
        for j, i in enumerate(idxs):
            np.save(os.path.join(args.dataset_cache, f"{i}.teacher.npy"),
                    feats[j].astype(np.float32))
        print(f"  {min(lo + args.batch_size, len(todo))}/{len(todo)}", end="\r")
    print(f"\ndone: {len(todo)} feature files written to {args.dataset_cache}")


if __name__ == "__main__":
    main()
