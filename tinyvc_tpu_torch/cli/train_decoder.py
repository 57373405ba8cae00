"""CLI: the decoder's GAN training, before and after the discriminator joins
at ``-d-join`` (counterpart of `tinyvc_tpu/cli/train_decoder.py`).

    python -m tinyvc_tpu_torch.cli.train_decoder --dataset-cache dataset_cache \\
        -encp models/two_speaker/encoder_B.npz -decp models/decoder \\
        --init-decoder models/two_speaker/decoder_B.npz

The cache is `cli/preprocess.py`'s (``{i}.wav`` at 24 kHz, ``{i}.f0.npy``);
``-encp`` a params-only ``.npz``, a reference ``.pt`` or the checkpoint
directory of `cli/train_encoder.py`; ``-decp`` the checkpoint directory,
resumed when it holds a checkpoint; ``--init-decoder`` an ``.npz`` to start
from instead of a random init. The discriminator is drawn at random, or
resumed from the checkpoint; its MRD runs the default
``mrd_conv_impl="lax"`` (the JAX CLI has no flag for it either).
``--device-data`` holds the cache on the device, ``-K`` runs K steps a
window on it (0: the log interval), with K dividing the join. ``--device
cuda`` (the default) fails when CUDA is absent; ``--device cpu`` runs the
kernels' plain versions. ``--remat`` recomputes the layer-by-layer U-Net's
blocks in the backward (`models/decoder.py::FilterNet`; the fused training
U-Net, CUDA's default, does not read it, as in JAX).

Data-parallel training runs one process per card, each launched with the
same flags and ``--coordinator-address host:port --num-processes N
--process-id i`` (NCCL; gloo with ``--device cpu``), ``-b`` the global
batch (`train/loop.py`, `parallel/mesh.py`).
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser(description="train the DDSP vocoder (PyTorch/CUDA)")
    p.add_argument("--dataset-cache", default="dataset_cache")
    p.add_argument("-encp", "--encoder-path", default=None,
                   help="the frozen encoder: a params-only .npz, a reference .pt or an "
                   "encoder checkpoint directory (default: random)")
    p.add_argument("-decp", "--decoder-path", default="models/decoder",
                   help="checkpoint directory")
    p.add_argument("--init-decoder", default=None,
                   help="params-only .npz to start from when -decp holds no checkpoint")
    p.add_argument("-d-join", "--discriminator-join", default=100000, type=int)
    p.add_argument("-step", "--max-steps", default=300000, type=int)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("-b", "--batch-size", default=16, type=int)
    p.add_argument("--log-interval", default=50, type=int)
    p.add_argument("--save-interval", default=500, type=int)
    p.add_argument("--log-dir", default="./logs")
    p.add_argument("-spec-type", choices=["ms-stft", "mel"], default="ms-stft")
    p.add_argument("--weight-adv", default=2.0, type=float)
    p.add_argument("--weight-dsp", default=1.0, type=float)
    p.add_argument("--weight-spec", default=1.0, type=float)
    p.add_argument("--weight-feat", default=2.0, type=float)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--remat", action="store_true",
                   help="recompute the U-Net's blocks in the backward (the layer-by-layer U-Net)")
    p.add_argument("--device-data", action="store_true",
                   help="upload the whole chunk cache to the device once and gather batches "
                   "there")
    p.add_argument("-K", "--steps-per-dispatch", default=0, type=int,
                   help="with --device-data: K steps per window (0 = auto; 1 = one at a time)")
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
    from ..train.loop import train_decoder

    cfg = TinyVCConfig()
    if args.remat:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, remat=True))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        max_steps=args.max_steps,
        discriminator_join=args.discriminator_join,
        weight_adv=args.weight_adv,
        weight_dsp=args.weight_dsp,
        weight_spec=args.weight_spec,
        weight_feat=args.weight_feat,
    ))
    train_decoder(cfg, dataset_dir=args.dataset_cache, encoder_path=args.encoder_path,
                  ckpt_dir=args.decoder_path, log_dir=args.log_dir,
                  spec_loss_type=args.spec_type, device=args.device,
                  init_decoder=args.init_decoder, device_data=args.device_data,
                  steps_per_dispatch=args.steps_per_dispatch)


if __name__ == "__main__":
    main()
