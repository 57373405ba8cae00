"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

- A, `oscillator.py`: the additive oscillator bank
  (replaces `tinyvc_tpu/ops/pallas/oscillator.py::_pallas_forward`)
- B, `noise.py`: hashed-phase filtered noise
  (replaces `tinyvc_tpu/ops/pallas/noise.py::pallas_oscillate_noise`)
- C, `resample.py`: integer-factor linear upsampling
  (replaces `tinyvc_tpu/ops/pallas/resample.py::pallas_upsample_t`)

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for CUDA tensors, or raises. `build.py` compiles `csrc/*.cu` with one
``nvcc`` call at first use.
"""
