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

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for CUDA tensors, or raises. `build.py` compiles `csrc/*.cu` with one
``nvcc`` call at first use.
"""
