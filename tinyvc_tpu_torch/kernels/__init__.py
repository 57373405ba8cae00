"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

- A, `oscillator.py`: the additive oscillator bank
  (replaces `tinyvc_tpu/ops/pallas/oscillator.py::_pallas_forward`)
- B, `noise.py`: hashed-phase filtered noise
  (replaces `tinyvc_tpu/ops/pallas/noise.py::pallas_oscillate_noise`)
- C, `resample.py`: integer-factor linear upsampling: the energy
  estimator's x64 and the fused U-Net's five up stages
  (replaces `tinyvc_tpu/ops/pallas/resample.py::pallas_upsample_t`)
- D, `resample.py`: integer-factor decimation: the fused U-Net's four down
  stages (replaces `tinyvc_tpu/ops/pallas/resample.py::pallas_downsample_t`)
- E, `filter_stage.py`: the U-Net's stem conv and Downsample chains
  (replaces `tinyvc_tpu/ops/pallas/filter_stage.py::_run_down_kernel`)
- F, `filter_stage.py`: the U-Net's Upsample chains, the last with the
  output conv folded in
  (replaces `tinyvc_tpu/ops/pallas/filter_stage.py::fused_upsample_chain_t`)
- G, `spectrogram.py`: the magnitude spectrogram as a windowed DFT product
  (replaces `tinyvc_tpu/ops/pallas/spectrogram.py::pallas_spectrogram`)
- H, `knn.py`: kNN matching against one dictionary, with the mean of its
  bf16-rounded rows
  (replaces `tinyvc_tpu/ops/pallas/knn.py::pallas_match_features`)

The training step's gradients (`train/decoder_train.py`):

- I, `oscillator.py`: the oscillator bank's amplitude gradient
  (replaces `tinyvc_tpu/ops/pallas/oscillator.py::_pallas_backward_amps`)
- J, `resample.py`: the gradients of C and D
  (replaces `tinyvc_tpu/ops/pallas/resample.py::_up_bwd`, ``_down_bwd``)
- K, `filter_stage.py`: the Upsample chains' gradient, with and without the
  folded output conv (replaces
  `tinyvc_tpu/ops/pallas/filter_stage.py::fused_upsample_chain_t_bwd`)
- L, `filter_stage.py`: the Downsample chains' and the stem's gradients
  (replaces `tinyvc_tpu/ops/pallas/filter_stage.py::_run_down_bwd`)

The post-join GAN step's discriminator (`models/discriminator.py`,
``mrd_conv_impl="fused"``):

- M, `mrd.py`: the MRD's conv stack in the phase-plane layout
  (replaces `tinyvc_tpu/ops/pallas/mrd.py::_fwd_pallas`)
- N, `mrd.py`: its masked cotangents and input gradient
  (replaces the dx sweep of `tinyvc_tpu/ops/pallas/mrd.py::_mrd_bwd`)
- O, `mrd.py`: its weight and bias gradients
  (replaces the dW/db sweep of `tinyvc_tpu/ops/pallas/mrd.py::_mrd_bwd`)

C-F, J-L and M-O also take bf16 tensors, the serving profile's and the training
step's bf16-operand forms. Each wrapper takes
its plain version for tensors on the CPU and launches its kernel for CUDA
tensors, or raises. `build.py` compiles `csrc/*.cu` at first use, one
``nvcc`` per source, and launches every kernel under its tensor's device.
"""
