"""CLI: the encoder's training, pitch classification and distillation
(counterpart of `tinyvc_tpu/cli/train_encoder.py`).

    python -m tinyvc_tpu_torch.cli.train_encoder --dataset-cache dataset_cache \\
        -path models/encoder

The cache is `cli/preprocess.py`'s (``{i}.wav``, ``{i}.f0.npy``), with
``{i}.teacher.npy`` from `cli/precompute_teacher.py` when distilling (then
set ``TINYVC_NO_NATIVE_LOADER=1``, or pass ``--device-data``: the cached
features need the batches' indices); ``-path`` the checkpoint directory,
resumed when it holds a checkpoint, which `cli/train_decoder.py -encp` and
`cli/infer.py -encp` read. ``--device-data`` holds the cache on the device,
``-K`` runs K steps a window on it (0: the log interval). ``--device cuda``
(the default) fails when CUDA is absent; ``--device cpu`` runs on the CPU.
Data-parallel training runs one process per card, each launched with the
same flags and ``--coordinator-address host:port --num-processes N
--process-id i`` (NCCL; gloo with ``--device cpu``), ``-b`` the global
batch.
"""

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser(description="distillation of WavLM layer 4 + pitch estimation")
    p.add_argument("--dataset-cache", default="dataset_cache")
    p.add_argument("--noises", default="NONE")
    p.add_argument("--wavlm", default="microsoft/wavlm-base-plus")
    p.add_argument("-path", "--path", default="models/encoder")
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("-e", "--epoch", default=60, type=int)
    p.add_argument("-b", "--batch-size", default=16, type=int)
    p.add_argument("--log-interval", default=50, type=int)
    p.add_argument("--save-interval", default=500, type=int)
    p.add_argument("--log-dir", default="./logs")
    p.add_argument("--device-data", action="store_true",
                   help="upload the whole chunk cache (wave + f0) to the device once "
                   "and gather batches there")
    p.add_argument("-K", "--steps-per-dispatch", default=0, type=int,
                   help="with --device-data: K steps per window (0 = auto; 1 = one at a time)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--coordinator-address", default=None,
                   help="data-parallel: host:port of process 0 (one process per card)")
    p.add_argument("--num-processes", default=None, type=int)
    p.add_argument("--process-id", default=None, type=int)
    args = p.parse_args(argv)

    from ..parallel.mesh import init_distributed

    # before anything touches a card: each process takes its own
    try:
        init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                         args.device)
    except ValueError as e:
        p.error(str(e))

    from ..config import TinyVCConfig
    from ..train.loop import train_encoder

    cfg = TinyVCConfig()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
    ))
    train_encoder(cfg, dataset_dir=args.dataset_cache, ckpt_dir=args.path, log_dir=args.log_dir,
                  epochs=args.epoch, noises_dir=None if args.noises == "NONE" else args.noises,
                  teacher_model=args.wavlm, device_data=args.device_data,
                  steps_per_dispatch=args.steps_per_dispatch, device=args.device)


if __name__ == "__main__":
    main()
