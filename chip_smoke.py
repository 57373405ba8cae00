#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tinyvc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed; any failure exits non-zero:

1. env: Python, torch and CUDA versions, ``nvcc --version``, and the card's
   name and power limit from ``nvidia-smi``.
2. build: the CUDA kernels of `tinyvc_tpu_torch/kernels/csrc/`, one ``nvcc``
   per source, all started together, and one link.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the conversion path's shapes (B=1, F=320 frames, L=153,600 samples) and at
   a ragged shape (B=3 or 2, F=37), with kernel, plain and library times
   (CUDA events, median of 25 after warm-up) and the bound from bytes and
   FLOPs. The fused U-Net's kernels (C at its five up stages, D, E, F) run
   every stage's shapes with the two-speaker decoder's weights, in fp32 and
   in bf16; their rows sum the stages of one request. The spectrogram
   kernel G runs at the serving profile's B=8 (it runs only at B*F >= 2048;
   also timed at B=1) and the noise kernel B at B=1 and B=8, each beside
   its library call and its time before the FFT redesign
   (``OLD_DESIGN_MS``); the kNN kernel H at B=1 and B=8 against the
   2048-row dictionary (and a ragged B=2, F=37 against 300 rows).
4. convert: ``VoiceConverter`` on CUDA with the two-speaker weights and kNN
   index. The fp32 default config answers three requests (the 6 s demo
   utterance cold, warm, then a batch of 4), so the fused U-Net; every
   kernel's launch counter must rise; the output must be finite, as long as
   the input, within ``WAVE_ATOL`` of the same request on the CPU (fused
   too, ``use_fused_filter="on"``), and within ``MEL_L1_BOUND`` of the
   demo's converted rendition. The card's distance to its own
   layer-by-layer U-Net (``"off"``) is printed, not gated: the two differ
   near the utterance's ends by design. Then ``serving_config()`` answers
   B=1 (kernel H runs, the spectrogram is the FFT's) and B=8 (kernel G
   runs too): the bf16 launch counters of C-F and those of G and H must
   rise, G's must stay 0 at B=1; each request's stages are held to the
   CPU's serving functions on the card's own input to each stage
   (spectrogram, kNN, SourceNet, U-Net; ``SERVING_STAGE_RTOL``), and the
   output to the CPU's serving output, to the card's fp32 output
   (``SERVING_MEL_L1_BOUND``) and to the converted rendition. With two or
   more cards, one request runs on the last card while card 0 is current.
5. profile: warm request latency at B=1 and B=4 (fp32) and at B=1 and B=8
   (serving) and, from ``torch.profiler``, the device time of one request
   by kernel group and the device's idle share.
6. train: the decoder's pre-join training step at the shipped widths,
   B=16 x 2 s (16 windows of the demo's two utterances). Kernels I-L
   (the oscillator's amplitude gradient, the resample gradients, the up and
   down chains' gradients) against their plain versions at the step's
   shapes in fp32 and with bf16 operands, timed; one fp32 step with the
   two-speaker weights, its kernel path against its plain path (losses and
   every gradient leaf, ``STEP_*``; every kernel of the step must launch);
   the CLI's run of phase 7 gives the pre-join step's warm time.
7. post-join: the discriminator and the GAN step after its join. Kernels
   M, N, O (the fused MRD forward, its dy/dx sweep, its dW/db sweep)
   against their plain versions at the step's shapes (B=16, the 8000-sample
   crop, all four resolutions) in fp32 and bf16, timed beside the conv
   chain by ``F.conv2d`` (``MRD_TOL``); one fp32 post-join step with the
   fused MRD (the two-speaker encoder and decoder, a discriminator drawn
   from the seed, the log-mel loss), its kernel path against its plain path
   (six losses, every gradient leaf of both networks, ``STEP_*``; M, N and
   O must launch) and against the conv-form MRD's step
   (``POSTJOIN_FUSED_RTOL``); then the CLI across the join (``-d-join``,
   the conv-form MRD) and ``train/loop.py::train_decoder`` with the fused
   MRD in bf16 (M, N and O must launch), each with its warm post-join step
   time, peak memory and one profiled post-join step by kernel group.

The last two lines are one JSON object of per-kernel numbers and the
``{"ok": true, "device": ...}`` result. ``python3 chip_smoke.py --profile
[DIR]`` runs env, build and the profile phase only, of the port in DIR (a
checkout of another commit, default this one): unpack the parent commit
into a git-ignored directory and run parent, change, change, parent in one
call to compare two commits' request latency on one card. Needs CUDA and the rest of the repo;
imports nothing of JAX or `tinyvc_tpu`.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PITCH_SHIFT = 11.99  # the demo's own setting (demo/two_speaker/README.md)

# Tolerances. Each kernel against its plain version on the same inputs:
#  A: the plain version (the JAX package's XLA scheme) interpolates f0 with
#     fp32 coordinates over the whole utterance, and its phase drifts from
#     the float64 truth as time goes on: up to ~9e-3 at harmonic 15 and
#     amplitude 3 after 320 frames. The kernel interpolates within each
#     frame and stays ~1e-3 from the truth. 1e-2 bounds their difference;
#     the check against the float64 truth below (under 2e-2 and no more than
#     1.5x the plain version's error) is the tighter gate.
#  B: same hashed phases bit for bit; an fp32 mixed-radix inverse FFT
#     against cuFFT's irfft (1e-5, the JAX package's own kernel-vs-istft
#     bound).
#  C, D: the same fp32 products and sums in the same order: bit-exact, the
#     bound allows one rounding at values <= 1.
#  E, F (relative to the plain version's peak): fp32 sums of up to 3*384
#     terms in another order than cuDNN's (TF32 off on both sides), through
#     three (E) or four (F) convs, FiLM products and residual adds; the H100
#     showed at most 7.4e-7 of the peak (1.55e-6 at peak 2.08).
#  C, D in bf16: two products of bf16 values (exact in fp32), one fp32 sum,
#     one rounding to bf16, the same on both sides: bit-exact.
#  E, F in bf16 (relative to the peak): bf16 operands summed in fp32 in
#     another order than cuDNN's; an intermediate that straddles a bf16
#     rounding boundary moves one bf16 step, and the outputs are stored in
#     bf16: one bf16 step (2**-8) at the peak.
#  G: an fp32 mixed-radix FFT against the plain version's 1920-term fp32
#     DFT product (cuBLAS, which splits the sum at some shapes): 5e-6 of the
#     peak (the DFT design showed 1.4e-6 on the H100; the FFT's error grows
#     with log N, the product's with N).
#  H: fp32 similarities in another order than cuBLAS's may reorder a near
#     tie: neighbours must agree except where the plain version's
#     similarities of the two choices differ by under KNN_TIE; where they
#     agree, the mean of the same bf16 rows in the same order: 1e-6.
KERNEL_TOL = {"oscillator": 1e-2, "noise": 1e-5, "upsample": 1e-6, "downsample": 1e-6,
              "upsample_bf16": 0.0, "downsample_bf16": 0.0, "knn": 1e-6}
CHAIN_RTOL = {"down_chain": 1e-5, "up_chain": 1e-5, "down_chain_bf16": 2.0**-8,
              "up_chain_bf16": 2.0**-8, "spectrogram": 5e-6}
KNN_TIE = 1e-5
# Whole conversion, card against CPU and port against JAX (the CPU tests hold
# the port to the same bound): kernel A's phase is closer to the float64
# truth than the fp32 plain version (by up to ~7e-3 at amplitude 3), and the
# U-Net carries that into the waveform; 1e-3 is 0.2% of the output's peak
# (~0.5).
WAVE_ATOL = 1e-3
# Log-mel L1 of the port's 6 s output against demo/two_speaker/
# converted_A_to_B.wav. The CPU test measures the port there: 0.2426 with
# seed 0, which draws the rendition's own noise stream (JAX's PRNGKey(0));
# 0.354 to 0.357 with other noise; the source itself is 2.46 away.
MEL_L1_BOUND = 0.40
# Log-mel L1 of the serving profile's 6 s output against the fp32 profile's,
# both on the card. The JAX package's own serving output is 0.0906 from its
# fp32 output on this demo (tests/test_torch_serving.py measures both
# packages on the CPU); its 0.03 ceiling (tests/test_mixed_precision.py)
# holds for random weights on noise, not for these weights on speech.
SERVING_MEL_L1_BOUND = 0.09
# Stages of a serving request on the card, each against the CPU's serving
# function on the card's own input to that stage, relative to the CPU
# output's peak (log-mel distances cannot tell a bf16 function from the fp32
# one). The spectrogram and the kNN stages: G's and H's kernel tolerances
# above, which the fp32 rfft and retrieval would break. SourceNet's
# amplitudes and noise filter: bf16 products summed in another order than
# the CPU's (cuBLAS may split the sums at B=8's 2560 frames); a rounding that
# flips one bf16 step carries through the later ConvNeXt layers and the fp32
# heads: two bf16 steps (2**-7); the H100 showed at most 3.3e-3, and the fp32
# SourceNet is 1.0e-2 to 2.5e-2 away, so each must also be nearer the CPU's
# bf16 SourceNet than its fp32 one. The fused U-Net's waveform (row 0) is
# chaotic in bf16: its source is rounded to bf16 on entry, and on the CPU a
# 1e-6 relative perturbation of the source moves the output by 9.5e-3 of the
# peak, the fp32 U-Net is 1.1e-2 away (tests/test_torch_serving.py::
# test_bf16_fused_unet_is_chaotic), so it cannot tell bf16 from fp32 and is
# held to 2**-6 only (the H100 showed 1.16e-2); its kernels are held to
# their plain versions on equal inputs in the kernels phase.
SERVING_STAGE_RTOL = {"amps": 2.0**-7, "noise_kernel": 2.0**-7, "out": 2.0**-6}
SERVING_STAGE_NEARER_BF16 = ("amps", "noise_kernel")

# Kernels G and B in their DFT design, before the FFT one, ms per call on the
# H100 80GB HBM3 at 700 W (PERF.md sections 5 and 6, from this script's
# runs then): G ran at B*F >= 2048 only, so it has no B=1 time; B's B=8 time
# is the profiler's device time of one call in a serving B=8 request.
OLD_DESIGN_MS = {("spectrogram", 8): 1.3492, ("spectrogram", 1): "not measured",
                 ("noise", 1): 0.7939, ("noise", 8): 4.710}

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores


def _phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _done(name: str, t0: float) -> None:
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def _cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, calls: int = 20) -> float:
    """Device milliseconds of one call of ``fn``: the kernel time that
    ``torch.profiler`` records over ``calls`` calls, divided by ``calls``.
    Beside ``_cuda_ms``, whose events also hold the host's launch work
    whenever it outlasts the kernels."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    kernels, _ = _profile_call(lambda: [fn() for _ in range(calls)])
    return sum(ms for ms, _ in kernels.values()) / calls


def _bound(nbytes: float, flops: float, peak: float = FP32_FLOPS, fp32_flops: float = 0.0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations' time, ``flops`` over ``peak`` plus
    ``fp32_flops`` (work that stays fp32 beside bf16 products) over the
    fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / peak + fp32_flops / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase_env() -> str:
    import torch

    from tinyvc_tpu_torch.kernels import build

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    smi = shutil.which("nvidia-smi")
    _check(smi is not None, "nvidia-smi not found")
    card = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from tinyvc_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"built {path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _osc_truth(f0, amps, frame=480, sr=24000, fmin=20.0):
    """float64 ground truth of the oscillator bank, ``[B, H1, L]``."""
    import numpy as np

    B, F = f0.shape
    L = F * frame
    src = np.clip((np.arange(L) + 0.5) / frame - 0.5, 0, F - 1)
    j = np.floor(src).astype(int)
    j1 = np.minimum(j + 1, F - 1)
    fr = src - j

    def interp(x):
        return x[:, j] * (1 - fr) + x[:, j1] * fr

    phase = np.cumsum(interp(f0.astype(np.float64)) / sr, axis=1)
    uv = interp((f0 > fmin).astype(np.float64))
    out = np.empty((B, amps.shape[-1], L))
    for h in range(amps.shape[-1]):
        out[:, h] = (np.sin(2 * np.pi * np.mod(phase * (h + 1), 1.0)) * uv
                     * interp(amps[:, :, h].astype(np.float64)))
    return out


def phase_kernels() -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tinyvc_tpu_torch.dsp.stft import hann_window
    from tinyvc_tpu_torch.kernels.noise import oscillate_noise_hashed, oscillate_noise_plain
    from tinyvc_tpu_torch.kernels.oscillator import oscillator_bank, oscillator_bank_plain
    from tinyvc_tpu_torch.kernels.resample import upsample_linear, upsample_linear_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    hop, n_fft, bins, H1, factor = 480, 1920, 961, 15, 64
    results = {}
    cases_b = {}

    def report(name, case, err, tol):
        print(f"  {name} {case}: max_abs_err {err:.3e} (tolerance {tol:.0e})")
        _check(err <= tol, f"{name} {case}: error {err} > {tol}")

    # A: oscillator bank
    errs = []
    for B, F_ in ((1, 320), (3, 37)):
        f0 = (rng.uniform(80.0, 400.0, (B, F_))).astype(np.float32)
        f0[0, 5:15] = 0.0  # unvoiced run
        amps = (np.abs(rng.standard_normal((B, F_, H1))) + 0.1).clip(max=3.0).astype(np.float32)
        tf0, tamps = torch.from_numpy(f0).to(dev), torch.from_numpy(amps).to(dev)
        got = oscillator_bank(tf0, tamps)
        want = oscillator_bank_plain(tf0, tamps)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        truth = _osc_truth(f0, amps)
        e_kernel = float(np.abs(got.cpu().numpy() - truth).max())
        e_plain = float(np.abs(want.cpu().numpy() - truth).max())
        print(f"  oscillator B={B} F={F_}: vs float64 truth kernel {e_kernel:.3e}, "
              f"plain {e_plain:.3e}")
        _check(e_kernel < 2e-2 and e_kernel <= 1.5 * e_plain,
               f"oscillator off the float64 truth: {e_kernel} vs plain {e_plain}")
        report("oscillator", f"B={B} F={F_}", err, KERNEL_TOL["oscillator"])
        errs.append(err)
        if B == 1:
            main_a = (tf0, tamps)
    tf0, tamps = main_a
    L = tf0.shape[1] * hop
    nbytes = 4 * (tf0.numel() + tamps.numel() + H1 * L)
    results["oscillator"] = dict(
        name="oscillator", route="cuda", source="tinyvc_tpu_torch/kernels/csrc/oscillator.cu",
        replaces="tinyvc_tpu/ops/pallas/oscillator.py:133", max_abs_err=max(errs),
        ms=_cuda_ms(lambda: oscillator_bank(tf0, tamps)),
        plain_ms=_cuda_ms(lambda: oscillator_bank_plain(tf0, tamps)),
        # ~12 fp32 operations per output (interpolation, phase, wrap, sin, gains)
        bound=_bound(nbytes, 12.0 * H1 * L), library_ms=None,
    )

    # B: noise, seed and angle modes; B=8 is the serving profile's batch
    errs = []
    for B, F_ in ((1, 320), (3, 37), (8, 320)):
        mag = torch.from_numpy(np.abs(rng.standard_normal((B, F_, bins))).astype(np.float32)).to(dev)
        ang = torch.from_numpy(rng.uniform(-np.pi, np.pi, (B, F_, bins)).astype(np.float32)).to(dev)
        for mode, angle in (("seed", None), ("angle", ang)):
            got = oscillate_noise_hashed(mag, 7, hop, n_fft, angle=angle)
            want = oscillate_noise_plain(mag, 7, hop, n_fft, angle=angle)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            report("noise", f"{mode} B={B} F={F_}", err, KERNEL_TOL["noise"])
            errs.append(err)
        if F_ == 320:
            cases_b[B] = (mag, ang)
    win = hann_window(n_fft, dev)

    def noise_case(B):
        """(kernel ms, plain ms, torch.istft ms, bound) of kernel B at B, F=320."""
        mag, ang = cases_b[B]
        F_ = mag.shape[1]
        spec = F.pad(torch.polar(mag, ang), (0, 0, 1, 0)).transpose(1, 2).contiguous()

        def lib_istft():
            return torch.istft(spec, n_fft, hop, window=win, center=True)

        lib_err = float((lib_istft() - oscillate_noise_hashed(mag, 7, hop, n_fft, angle=ang)
                         ).abs().max())
        print(f"  noise B={B}: torch.istft vs kernel (angle mode) max_abs_err {lib_err:.3e}")
        # the work an FFT-based iSTFT needs: per frame a real inverse FFT
        # (2.5 n log2 n, half a complex FFT's 5 n log2 n), the polar product
        # (2 per bin), window and overlap-add (2 per sample) and the envelope
        # divide (1 per output sample); bytes: mag read once, output written once
        bound = _bound(4 * (mag.numel() + B * F_ * hop),
                       B * F_ * (2.5 * n_fft * math.log2(n_fft) + 2 * bins + 2 * n_fft + hop))
        def kernel():
            return oscillate_noise_hashed(mag, 7, hop, n_fft)

        print(f"  noise B={B} F=320: device time of one call: kernel "
              f"{_device_ms(kernel):.4f} ms, torch.istft {_device_ms(lib_istft):.4f} ms")
        return (_cuda_ms(kernel), _cuda_ms(lambda: oscillate_noise_plain(mag, 7, hop, n_fft)),
                _cuda_ms(lib_istft), bound)

    for B in (1, 8):
        ms, plain_ms, lib_ms, bound = noise_case(B)
        print(f"  noise B={B} F=320: kernel {ms:.4f} ms (the DFT design: "
              f"{OLD_DESIGN_MS[('noise', B)]}), torch.istft {lib_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        if B == 1:
            results["noise"] = dict(
                name="noise", route="cuda", source="tinyvc_tpu_torch/kernels/csrc/noise.cu",
                replaces="tinyvc_tpu/ops/pallas/noise.py:175", max_abs_err=max(errs),
                ms=ms, plain_ms=plain_ms, bound=bound, library_ms=lib_ms,
            )

    # C: x64 linear upsample of the pooled energy
    errs = []
    for B, T in ((1, 320 * hop // factor), (3, 37 * hop // factor)):
        x = torch.from_numpy(rng.uniform(0.0, 1.0, (B, T)).astype(np.float32)).to(dev)
        got = upsample_linear(x, factor)
        want = upsample_linear_plain(x, factor)
        lib = F.interpolate(x[:, None], scale_factor=factor, mode="linear",
                            align_corners=False)[:, 0]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        report("upsample", f"B={B} T={T}", err, KERNEL_TOL["upsample"])
        print(f"  upsample B={B}: F.interpolate vs kernel max_abs_err "
              f"{float((lib - got).abs().max()):.3e}")
        errs.append(err)
        if B == 1:
            main_c = x
    x = main_c
    results["upsample"] = dict(
        name="upsample", route="cuda", source="tinyvc_tpu_torch/kernels/csrc/resample.cu",
        replaces="tinyvc_tpu/ops/pallas/resample.py:180", max_abs_err=max(errs),
        ms=_cuda_ms(lambda: upsample_linear(x, factor)),
        plain_ms=_cuda_ms(lambda: upsample_linear_plain(x, factor)),
        # 3 multiplies and 2 adds per output
        bound=_bound(4 * (x.numel() * (1 + factor)), 5.0 * x.numel() * factor),
        library_ms=_cuda_ms(lambda: F.interpolate(x[:, None], scale_factor=factor,
                                                  mode="linear", align_corners=False)),
    )
    phase_unet_kernels(results, rng, dev)
    phase_unet_kernels(results, rng, dev, bf16=True)
    phase_gh_kernels(results, rng, dev)
    for r in results.values():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def _sum_bounds(bounds):
    """One row's bound over several calls: the sum of each call's bound,
    named by the kind (bytes or operations) that bounds most of it."""
    by = {"bytes": 0.0, "operations": 0.0}
    for ms, kind in bounds:
        by[kind] += ms
    return sum(by.values()), max(by, key=by.get)


def phase_unet_kernels(results: dict, rng, dev, bf16: bool = False) -> None:
    """Kernels D, E, F, and C at the U-Net's up stages, each call of one
    fused U-Net request against its plain version, with the two-speaker
    decoder's packed weights and N(0, 0.25) activations: at B=1, F=320 (timed,
    summed into one row per kernel) and at a ragged B=2, F=37. With ``bf16``,
    the serving profile's forms: bf16 activations, the up chains storing bf16
    but for the folded last one; rows ``<name>_bf16``, bounded by the bf16
    tensor-core peak where the products could use it."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tinyvc_tpu_torch.config import DecoderConfig
    from tinyvc_tpu_torch.infer.generator import exact_fp32
    from tinyvc_tpu_torch.kernels import filter_stage as fs
    from tinyvc_tpu_torch.kernels.resample import (downsample_linear, downsample_linear_plain,
                                                   upsample_linear, upsample_linear_plain)
    from tinyvc_tpu_torch.ops.fused_filternet import fused_weights
    from tinyvc_tpu_torch.utils.weights import decoder_from_jax, load_npz

    cfg = DecoderConfig()
    dec = decoder_from_jax(load_npz(os.path.join(ROOT, "models", "two_speaker", "decoder_B.npz")),
                           cfg).to(dev)
    n_src = cfg.num_harmonics + 2
    pack = n_src + 1 + (-(n_src + 1)) % 8
    w = fused_weights(dec.filter_net, pack)
    chans, facs = list(cfg.filter_channels), list(cfg.filter_factors)
    sfx = "_bf16" if bf16 else ""
    dt = torch.bfloat16 if bf16 else torch.float32
    isz = 2 if bf16 else 4  # bytes of an activation
    mm_peak = BF16_FLOPS if bf16 else FP32_FLOPS
    names = ("upsample", "downsample", "down_chain", "up_chain")
    acc = {k + sfx: dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bounds=[]) for k in names}

    def randn(*shape):
        return torch.from_numpy((0.5 * rng.standard_normal(shape)).astype(np.float32)).to(dev, dt)

    def check(name, case, kernel, plain, tol, relative, timed, bound, library=None):
        name += sfx
        with exact_fp32():
            got, want = kernel().float(), plain().float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            peak = float(want.abs().max())
            limit = tol * peak if relative else tol
            print(f"  {name} {case}: max_abs_err {err:.3e} (tolerance {limit:.3e}"
                  f"{f' = {tol:.0e} x peak {peak:.3f}' if relative else ''})")
            _check(err <= limit, f"{name} {case}: error {err} > {limit}")
            a = acc[name]
            a["err"] = max(a["err"], err)
            if timed:
                ms, plain_ms = _cuda_ms(kernel), _cuda_ms(plain)
                lib_ms = None if library is None else _cuda_ms(library)
                print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                      f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
                      f"{bound[0]:.4f} ms ({bound[1]})")
                a["ms"] += ms
                a["plain"] += plain_ms
                a["lib"] += lib_ms or 0.0
                a["bounds"].append(bound)

    def decimate_lib(x, f):
        if f % 2:
            return lambda: x[:, f // 2::f].contiguous()
        return lambda: F.avg_pool1d(x[:, None, f // 2 - 1:], 2, f)[:, 0]

    for B, F_ in ((1, 320), (2, 37)):
        timed = B == 1
        L = F_ * 480
        # stem over the packed source: harmonics and noise, energy, zero rows
        x = randn(B, pack, L)
        x[:, n_src] = x[:, n_src].abs()
        x[:, n_src + 1:] = 0.0
        cs = w.stem[0].shape[0]
        check("down_chain", f"stem B={B} [{pack}({n_src + 1}) -> {cs}, {L}]",
              lambda: fs.conv3(x, *w.stem), lambda: fs.conv3_plain(x, *w.stem),
              CHAIN_RTOL["down_chain" + sfx], True, timed,
              _bound(isz * (x.numel() + B * cs * L), 2.0 * B * L * cs * 3 * (n_src + 1),
                     mm_peak))
        T = L
        for cin, f, wd in zip(reversed(chans[1:]), reversed(facs[1:]), w.down):
            xin = randn(B * cin, T)
            check("downsample", f"B*C={B * cin} T={T} /{f}",
                  lambda: downsample_linear(xin, f), lambda: downsample_linear_plain(xin, f),
                  KERNEL_TOL["downsample" + sfx], False, timed,
                  _bound(isz * (xin.numel() + xin.numel() // f),
                         0.0 if f % 2 else 3.0 * xin.numel() // f),
                  library=decimate_lib(xin, f))
            T //= f
            z = randn(B, cin, T)
            co = wd[0].shape[0]
            check("down_chain", f"B={B} [{cin} -> {co}, {T}]",
                  lambda: fs.downsample_chain(z, *wd), lambda: fs.downsample_chain_plain(z, *wd),
                  CHAIN_RTOL["down_chain" + sfx], True, timed,
                  _bound(isz * B * T * (cin + co), 2.0 * B * T * (6 * cin * cin + 4 * cin * co),
                         mm_peak))
        Tx = F_
        for i, (c, f, wu) in enumerate(zip(chans, facs, w.up)):
            xin = randn(B * c, Tx)
            check("upsample", f"B*C={B * c} T={Tx} x{f}",
                  lambda: upsample_linear(xin, f), lambda: upsample_linear_plain(xin, f),
                  KERNEL_TOL["upsample" + sfx], False, timed,
                  _bound(isz * xin.numel() * (1 + f), 5.0 * xin.numel() * f),
                  library=lambda: F.interpolate(xin[:, None], scale_factor=f, mode="linear",
                                                align_corners=False))
            Tx *= f
            xu, cond = randn(B, c, Tx), randn(B, c, Tx)
            fold = i == len(chans) - 1
            co = 1 if fold else wu[4].shape[0]
            kw = dict(fold_k=wu[4].shape[0], bout=wu[6]) if fold else dict(out_dtype=dt)
            osz = 4 if fold else isz
            ww = wu[:6]
            # four k=3 convs and the two FiLMs' [4C, C] product: 32 C^2 per
            # sample, and the output 1x1's 2 * Co' * C, at the products' peak;
            # the folded k=7 conv's 2 * 7 * C, fp32 in either profile, at the
            # fp32 peak
            k5 = wu[4].shape[0]
            out_flops = 2.0 * B * Tx * k5 * c
            check("up_chain", f"B={B} [{c} -> {co}{' folded' if fold else ''}, {Tx}]",
                  lambda: fs.upsample_chain(xu, cond, *ww, **kw),
                  lambda: fs.upsample_chain_plain(xu, cond, *ww, **kw),
                  CHAIN_RTOL["up_chain" + sfx], True, timed,
                  _bound(isz * B * Tx * 2 * c + osz * B * Tx * co,
                         B * Tx * 32.0 * c * c + (0.0 if fold else out_flops), mm_peak,
                         fp32_flops=out_flops if fold else 0.0))

    kernels_dir = "tinyvc_tpu_torch/kernels/csrc"
    a = acc["upsample" + sfx]
    if not bf16:
        up = results["upsample"]
        up.update(max_abs_err=max(up["max_abs_err"], a["err"]), ms=up["ms"] + a["ms"],
                  plain_ms=up["plain_ms"] + a["plain"], library_ms=up["library_ms"] + a["lib"],
                  bound=_sum_bounds([up["bound"]] + a["bounds"]))
    rows = [("downsample", "resample.cu", "tinyvc_tpu/ops/pallas/resample.py:198", True),
            ("down_chain", "filter_stage.cu", "tinyvc_tpu/ops/pallas/filter_stage.py:595", False),
            ("up_chain", "filter_stage.cu", "tinyvc_tpu/ops/pallas/filter_stage.py:354", False)]
    if bf16:
        rows.insert(0, ("upsample", "resample.cu", "tinyvc_tpu/ops/pallas/resample.py:180", True))
    for name, source, replaces, lib in rows:
        a = acc[name + sfx]
        results[name + sfx] = dict(
            name=name + sfx, route="cuda", source=f"{kernels_dir}/{source}", replaces=replaces,
            max_abs_err=a["err"], ms=a["ms"], plain_ms=a["plain"],
            bound=_sum_bounds(a["bounds"]), library_ms=a["lib"] if lib else None,
        )


def _demo_wave(B: int):
    """The 6 s demo utterance, ``B`` times, each copy shifted by 480*b
    samples (a circular roll), ``[B, 153600]`` fp32 numpy."""
    import numpy as np

    from tinyvc_tpu_torch.utils.audio_io import load_audio

    wave = load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))
    return np.stack([np.roll(wave, 480 * b) for b in range(B)])


def phase_gh_kernels(results: dict, rng, dev) -> None:
    """Kernel G at the serving profile's B=8 (and a ragged B=2, F=37), and
    kernel H at B=1 (timed) and B=8 against the 2048-row dictionary, cos,
    at B=1 with IP and L2 and alpha 0.5, and at a ragged B=2, F=37 against
    300 rows."""
    import numpy as np
    import torch

    from tinyvc_tpu_torch.dsp.padding import pad_to_bucket
    from tinyvc_tpu_torch.dsp.stft import spectrogram as fft_spectrogram
    from tinyvc_tpu_torch.infer.generator import exact_fp32
    from tinyvc_tpu_torch.kernels import knn
    from tinyvc_tpu_torch.kernels import spectrogram as sp
    from tinyvc_tpu_torch.ops.retrieval import match_features
    from tinyvc_tpu_torch.utils.weights import load_index

    n_fft, hop, bins = 1920, 480, 961
    cases_g = {}
    with exact_fp32():
        errs = []
        for B, F_ in ((8, 320), (2, 37), (1, 320)):
            # the request as the converter pads it (F=320), or its first 37 frames
            x = torch.from_numpy(pad_to_bucket(_demo_wave(B), hop)[0][:, :F_ * hop].copy()).to(dev)
            got, want = sp.spectrogram(x), sp.spectrogram_plain(x)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            peak = float(want.abs().max())
            tol = CHAIN_RTOL["spectrogram"] * peak
            lib_err = float((got - fft_spectrogram(x)).abs().max())
            print(f"  spectrogram B={B} F={F_}: max_abs_err {err:.3e} (tolerance {tol:.3e} = "
                  f"{CHAIN_RTOL['spectrogram']:.0e} x peak {peak:.3f}); torch.fft vs kernel "
                  f"{lib_err:.3e}")
            _check(err <= tol, f"spectrogram B={B}: error {err} > {tol}")
            errs.append(err)
            if F_ == 320:
                cases_g[B] = x
        for B in (8, 1):
            x = cases_g[B]
            frames = B * (x.shape[1] // hop)
            row = dict(
                ms=_cuda_ms(lambda: sp.spectrogram(x)),
                plain_ms=_cuda_ms(lambda: sp.spectrogram_plain(x)),
                # the work an FFT-based spectrogram needs: per frame the window
                # (1 per sample), a real FFT (2.5 n log2 n, half a complex FFT's
                # 5 n log2 n) and the magnitude (two products, an add and a
                # square root per bin); bytes: the wave in once, the
                # magnitudes out once
                bound=_bound(4 * (x.numel() + frames * bins),
                             frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 4 * bins)),
                library_ms=_cuda_ms(lambda: fft_spectrogram(x)),
            )
            print(f"  spectrogram B={B} F=320: device time of one call: kernel "
                  f"{_device_ms(lambda: sp.spectrogram(x)):.4f} ms, torch.fft "
                  f"{_device_ms(lambda: fft_spectrogram(x)):.4f} ms")
            print(f"  spectrogram B={B} F=320: kernel {row['ms']:.4f} ms (the DFT design: "
                  f"{OLD_DESIGN_MS[('spectrogram', B)]}), torch.fft {row['library_ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
                  f"({row['bound'][1]})")
            if B == 8:
                results["spectrogram"] = dict(
                    name="spectrogram", route="cuda",
                    source="tinyvc_tpu_torch/kernels/csrc/spectrogram.cu",
                    replaces="tinyvc_tpu/ops/pallas/spectrogram.py:165", max_abs_err=max(errs),
                    **row)

        ref = torch.from_numpy(load_index(os.path.join(ROOT, "models", "two_speaker",
                                                       "index_B.npy"))).to(dev)
        N, C = ref.shape
        errs = []
        # the last case is ragged: 37 frames, a 300-row slice of the dictionary
        for B, F_, n, metric, alpha in ((1, 320, N, "cos", 0.0), (8, 320, N, "cos", 0.0),
                                        (1, 320, N, "IP", 0.5), (1, 320, N, "L2", 0.5),
                                        (2, 37, 300, "cos", 0.5)):
            # content-like frames: dictionary rows plus noise
            dic = ref[:n]
            pick = torch.from_numpy(rng.integers(0, n, (B, F_))).to(dev)
            noise = torch.from_numpy(rng.standard_normal((B, F_, C)).astype(np.float32)).to(dev)
            src = (dic[pick] + 0.05 * noise).contiguous()
            got, gi = knn.match_features_knn(src, dic, metric=metric, alpha=alpha,
                                             return_indices=True)
            want, wi = knn.match_features_knn_plain(src, dic, metric=metric, alpha=alpha,
                                                    return_indices=True)
            torch.cuda.synchronize()
            errs.append(_check_knn(f"knn {metric} alpha={alpha} B={B} F={F_} N={n}", src, dic,
                                   metric, got, gi, want, wi))
            if B == 1 and metric == "cos" and n == N:
                main_h = src
        src = main_h
        R = src.shape[0] * src.shape[1]
        # the wrapper prepares a dictionary once (kernels/knn.py::
        # prepared_dictionary); the row's times are those of a prepared one
        print(f"  knn: dictionary preparation, once per dictionary, "
              f"{_cuda_ms(lambda: knn._dictionary(ref, 'cos')):.4f} ms")
        results["knn"] = dict(
            name="knn", route="cuda", source="tinyvc_tpu_torch/kernels/csrc/knn.cu",
            replaces="tinyvc_tpu/ops/pallas/knn.py:104", max_abs_err=max(errs),
            ms=_cuda_ms(lambda: knn.match_features_knn(src, ref)),
            plain_ms=_cuda_ms(lambda: knn.match_features_knn_plain(src, ref)),
            # the [R, C] x [C, N] similarity product; bytes: source and
            # dictionary in, matched frames out
            bound=_bound(4 * (2 * R * C + N * C), 2.0 * R * N * C),
            library_ms=_cuda_ms(lambda: match_features(src, ref)),
        )
        src8 = torch.from_numpy(rng.standard_normal((8, 320, C)).astype(np.float32)).to(dev)
        src8 = (ref[torch.from_numpy(rng.integers(0, N, (8, 320))).to(dev)] + 0.05 * src8)
        print(f"  knn B=8: kernel {_cuda_ms(lambda: knn.match_features_knn(src8, ref)):.4f} ms, "
              f"library {_cuda_ms(lambda: match_features(src8, ref)):.4f} ms, bound "
              f"{_bound(4 * (2 * 8 * 320 * C + N * C), 2.0 * 8 * 320 * N * C)[0]:.4f} ms")


def _check_knn(label: str, src, dic, metric: str, got, gi, want, wi) -> float:
    """Kernel H's output ``got`` and neighbours ``gi`` against its plain
    version's ``want``, ``wi`` on the same ``src`` and dictionary ``dic``:
    the neighbours agree but on frames where the plain similarities of the
    two choices differ by under ``KNN_TIE`` (a reordered near tie), and on
    the frames where they agree the outputs agree within
    ``KERNEL_TOL["knn"]``. Compared on the CPU; returns the error."""
    import torch

    src, dic, got, gi, want, wi = (t.cpu() for t in (src, dic, got, gi, want, wi))
    same = (gi == wi).all(-1)
    if not bool(same.all()):
        xs = src.float()
        if metric == "cos":
            xs = xs / (xs.norm(dim=-1, keepdim=True) + 1e-6)
        rs = dic / (dic.norm(dim=-1, keepdim=True) + 1e-6) if metric == "cos" else dic
        sims = torch.matmul(xs, rs.T)
        if metric == "L2":
            sims = 2.0 * sims - (dic * dic).sum(-1)
        gap = (sims.gather(-1, gi).sort(-1).values
               - sims.gather(-1, wi).sort(-1).values).abs()[~same]
        print(f"  {label}: {int((~same).sum())} of {same.numel()} frames pick other "
              f"neighbours, similarity gap {float(gap.max()):.3e}")
        _check(float(gap.max()) < KNN_TIE, f"{label}: neighbours differ by "
               f"{float(gap.max())} in similarity")
    err = float((got - want).abs()[same].max())
    print(f"  {label}: neighbours equal on {float(same.float().mean()):.4f} of frames, "
          f"max_abs_err {err:.3e} (tolerance {KERNEL_TOL['knn']:.0e})")
    _check(err <= KERNEL_TOL["knn"], f"{label}: error {err}")
    return err


def phase_convert(card: str) -> dict:
    import numpy as np
    import torch

    from tinyvc_tpu_torch.config import DecoderConfig, TinyVCConfig
    from tinyvc_tpu_torch.dsp.mel import log_mel_l1
    from tinyvc_tpu_torch.infer.generator import VoiceConverter
    from tinyvc_tpu_torch.kernels.filter_stage import conv3, downsample_chain, upsample_chain
    from tinyvc_tpu_torch.kernels.noise import oscillate_noise_hashed
    from tinyvc_tpu_torch.kernels.oscillator import oscillator_bank
    from tinyvc_tpu_torch.kernels.resample import downsample_linear, upsample_linear
    from tinyvc_tpu_torch.utils.audio_io import load_audio
    from tinyvc_tpu_torch.utils.weights import load_index, load_npz

    models = os.path.join(ROOT, "models", "two_speaker")
    demo = os.path.join(ROOT, "demo", "two_speaker")
    enc = load_npz(os.path.join(models, "encoder_B.npz"))
    dec = load_npz(os.path.join(models, "decoder_B.npz"))
    index = load_index(os.path.join(models, "index_B.npy"))
    wave = load_audio(os.path.join(demo, "source_A.wav"))
    seconds = wave.shape[0] / 24000.0
    vc = VoiceConverter(enc, dec, device="cuda")
    target = torch.from_numpy(index).to(vc.device)  # the speaker's dictionary, moved once

    wrappers = (oscillator_bank, oscillate_noise_hashed, upsample_linear, downsample_linear,
                conv3, downsample_chain, upsample_chain)
    for w in wrappers:
        w.launches = 0
    outs = []
    for label, x in (("cold B=1", wave), ("warm B=1", wave), ("B=4", np.stack([wave] * 4))):
        t0 = time.perf_counter()
        out = vc.convert(x, target, PITCH_SHIFT, seed=SEED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = 1 if x.ndim == 1 else x.shape[0]
        print(f"  request {label}: {dt * 1e3:.1f} ms, {n * seconds / dt:.1f} audio-s/s "
              f"({card})")
        _check(out.shape == x.shape, f"output shape {out.shape} != input {x.shape}")
        _check(bool(np.isfinite(out).all()), "non-finite output")
        outs.append(out)
    launches = {w.__name__: w.launches for w in wrappers}
    print(f"  launches during the three requests: {launches}")
    for name, n in launches.items():
        _check(n > 0, f"{name} was not launched on the conversion path")

    def config(flag):
        return TinyVCConfig(decoder=DecoderConfig(use_fused_filter=flag))

    # the CPU's "auto" is the layer-by-layer U-Net: hold the card's fused
    # output to the CPU's fused plain versions
    cpu = VoiceConverter(enc, dec, cfg=config("on"), device="cpu").convert(
        wave, index, PITCH_SHIFT, seed=SEED)
    diff = float(np.abs(outs[1] - cpu).max())
    print(f"  card vs CPU (both fused): max_abs_err {diff:.3e} (tolerance {WAVE_ATOL:.0e}); "
          f"peak {float(np.abs(cpu).max()):.3f}")
    _check(diff <= WAVE_ATOL, f"card output differs from the CPU by {diff}")
    off = VoiceConverter(enc, dec, cfg=config("off"), device="cuda").convert(
        wave, target, PITCH_SHIFT, seed=SEED)
    # the layer-by-layer U-Net pads each conv, the chains pad their input:
    # the two differ within the deep stages' reach of the ends (40 samples at
    # 1/240 of the rate is 9,600), by design
    dev = np.abs(outs[1] - off)
    bands = (0, 2400, 9600, 19200)
    print("  card fused vs card layer by layer (not gated): max |diff| "
          + ", ".join(f"{float(max(dev[a:b].max(), dev[len(dev) - b:len(dev) - a].max())):.3e}"
                      f" at {a}-{b}" for a, b in zip(bands, bands[1:]))
          + f", {float(dev[bands[-1]:-bands[-1]].max()):.3e} beyond {bands[-1]} samples "
          "of the ends")

    out = torch.from_numpy(outs[1])
    mel_conv = log_mel_l1(out, torch.from_numpy(load_audio(os.path.join(demo, "converted_A_to_B.wav"))))
    mel_src = log_mel_l1(out, torch.from_numpy(wave))
    print(f"  log-mel L1 vs converted_A_to_B.wav {mel_conv:.4f} (bound {MEL_L1_BOUND}), "
          f"vs source_A.wav {mel_src:.4f}")
    _check(mel_conv < MEL_L1_BOUND, f"log-mel L1 {mel_conv} >= {MEL_L1_BOUND}")
    launches = {
        "oscillator": launches["oscillator_bank"],
        "noise": launches["oscillate_noise_hashed"],
        "upsample": launches["upsample_linear"],
        "downsample": launches["downsample_linear"],
        "down_chain": launches["conv3"] + launches["downsample_chain"],
        "up_chain": launches["upsample_chain"],
    }
    serving_launches, serving, serving_b8 = phase_convert_serving(card, enc, dec, index, target,
                                                                  wave, outs[1])
    launches.update(serving_launches)
    phase_second_device(enc, dec, index, wave, outs[1], serving_b8)
    return launches, (vc, target, wave), serving


def phase_convert_serving(card: str, enc, dec, index, target, wave, fp32_out):
    """``serving_config()`` on the card: B=1 (kernel H, the FFT spectrogram)
    then B=8 (kernel G too); returns the launches of that run for G, H and
    the bf16 forms of C-F, the converter and its B=8 output."""
    import numpy as np
    import torch

    from tinyvc_tpu_torch.config import DecoderConfig, TinyVCConfig, serving_config
    from tinyvc_tpu_torch.dsp.mel import log_mel_l1
    from tinyvc_tpu_torch.infer.generator import VoiceConverter
    from tinyvc_tpu_torch.kernels.filter_stage import conv3, downsample_chain, upsample_chain
    from tinyvc_tpu_torch.kernels.knn import match_features_knn
    from tinyvc_tpu_torch.kernels.resample import downsample_linear, upsample_linear
    from tinyvc_tpu_torch.kernels.spectrogram import spectrogram
    from tinyvc_tpu_torch.utils.audio_io import load_audio
    from tinyvc_tpu_torch.utils.weights import decoder_from_jax

    demo = os.path.join(ROOT, "demo", "two_speaker")
    seconds = wave.shape[0] / 24000.0
    vc = VoiceConverter(enc, dec, cfg=serving_config(), device="cuda")
    bf16_wrappers = (upsample_linear, downsample_linear, conv3, downsample_chain, upsample_chain)
    for w in bf16_wrappers + (spectrogram, match_features_knn):
        w.launches = 0
    for w in bf16_wrappers:
        w.launches_bf16 = 0
    outs, stages = {}, {1: {}, 8: {}}
    for B in (1, 8):
        x = wave if B == 1 else _demo_wave(B)
        t0 = time.perf_counter()
        out = vc.convert(x, target, PITCH_SHIFT, seed=SEED, stages=stages[B])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"  serving request B={B} (cold): {dt * 1e3:.1f} ms, "
              f"{B * seconds / dt:.1f} audio-s/s ({card})")
        _check(out.shape == x.shape, f"serving output shape {out.shape} != input {x.shape}")
        _check(bool(np.isfinite(out).all()), "non-finite serving output")
        outs[B] = out
        if B == 1:
            _check(spectrogram.launches == 0, "kernel G ran at B*F = 320 < 2048")
    launches = {w.__name__: w.launches_bf16 for w in bf16_wrappers}
    launches.update(spectrogram=spectrogram.launches, knn=match_features_knn.launches)
    print(f"  launches during the two serving requests: {launches}")
    for name, n in launches.items():
        _check(n > 0, f"{name} was not launched on the serving path")
    # the batch's rows are the demo rolled by 480*b samples: row 0 is the demo;
    # it differs from B=1 by G's spectrogram against the FFT's, carried
    # through bf16 roundings, so each request is held stage by stage instead
    b1 = outs[1]
    print(f"  serving B=8 row 0 vs B=1 (not gated): max |diff| "
          f"{float(np.abs(outs[8][0] - b1).max()):.3e}")
    cpu_decs = {name: (decoder_from_jax(dec, dcfg, vc.cfg.audio), dcfg)
                for name, dcfg in (("bf16", DecoderConfig(compute_dtype="bfloat16",
                                                          use_fused_filter="on")),
                                   ("fp32", DecoderConfig(use_fused_filter="on")))}
    for B in (1, 8):
        _check_serving_stages(f"serving B={B}", stages[B], vc.cfg, target, index, cpu_decs)

    # the same request on the CPU: fused too, the spectrogram kernel's plain
    # version is not on this path (B*F < 2048), kNN's is
    cfg_cpu = serving_config()
    cfg_cpu = TinyVCConfig(decoder=DecoderConfig(compute_dtype="bfloat16",
                                                 use_fused_filter="on"),
                           audio=cfg_cpu.audio, retrieval=cfg_cpu.retrieval)
    cpu = VoiceConverter(enc, dec, cfg=cfg_cpu, device="cpu").convert(
        wave, index, PITCH_SHIFT, seed=SEED)
    mel_cpu = log_mel_l1(torch.from_numpy(b1), torch.from_numpy(cpu))
    print(f"  serving card vs CPU (both fused): log-mel L1 {mel_cpu:.4f} (bound "
          f"{SERVING_MEL_L1_BOUND}), max |diff| {float(np.abs(b1 - cpu).max()):.3e}")
    _check(mel_cpu < SERVING_MEL_L1_BOUND, f"serving card vs CPU log-mel L1 {mel_cpu}")
    mel_fp32 = log_mel_l1(torch.from_numpy(b1), torch.from_numpy(fp32_out))
    print(f"  serving vs fp32 on the card: log-mel L1 {mel_fp32:.4f} (bound "
          f"{SERVING_MEL_L1_BOUND}), max |diff| {float(np.abs(b1 - fp32_out).max()):.3e}")
    _check(mel_fp32 < SERVING_MEL_L1_BOUND, f"serving vs fp32 log-mel L1 {mel_fp32}")
    mel_conv = log_mel_l1(torch.from_numpy(b1),
                          torch.from_numpy(load_audio(os.path.join(demo, "converted_A_to_B.wav"))))
    print(f"  serving log-mel L1 vs converted_A_to_B.wav {mel_conv:.4f} (bound {MEL_L1_BOUND})")
    _check(mel_conv < MEL_L1_BOUND, f"serving log-mel L1 {mel_conv} >= {MEL_L1_BOUND}")
    return {
        "upsample_bf16": launches["upsample_linear"],
        "downsample_bf16": launches["downsample_linear"],
        "down_chain_bf16": launches["conv3"] + launches["downsample_chain"],
        "up_chain_bf16": launches["upsample_chain"],
        "spectrogram": launches["spectrogram"],
        "knn": launches["knn"],
    }, vc, outs[8]


def _check_serving_stages(label: str, st: dict, cfg, target, index, cpu_decs: dict) -> None:
    """One serving request's stages ``st`` (``VoiceConverter.convert``'s
    ``stages``), each against the CPU on the card's own input to it: the
    spectrogram against the FFT's on the card (kernel G's tolerance), the
    matched frames against kernel H's plain version (H's rules), SourceNet
    and the fused U-Net (row 0) against ``cpu_decs``' bf16 and fp32
    decoders (``SERVING_STAGE_RTOL``; SourceNet also nearer bf16). Prints
    every comparison before it checks any."""
    import torch

    from tinyvc_tpu_torch.dsp.stft import spectrogram as fft_spectrogram
    from tinyvc_tpu_torch.kernels import knn
    from tinyvc_tpu_torch.ops.fused_filternet import filternet_fused_apply

    a, r = cfg.audio, cfg.retrieval
    failed = []
    with torch.inference_mode():
        want = fft_spectrogram(st["input"], a.n_fft, a.hop_size)
        err, peak = float((st["spec"] - want).abs().max()), float(want.abs().max())
        tol = CHAIN_RTOL["spectrogram"] * peak
        print(f"  {label} spectrogram vs the FFT's: max_abs_err {err:.3e} (tolerance "
              f"{tol:.3e} = {CHAIN_RTOL['spectrogram']:.0e} x peak {peak:.3f})")
        if err > tol:
            failed.append(f"spectrogram {err}")

        # the path's matched frames are kernel H's; its neighbours come from
        # one more call on the same input, after the launches were counted
        again, gi = knn.match_features_knn(st["content"], target, r.k, r.alpha, r.metric,
                                           return_indices=True)
        if not torch.equal(again, st["matched"]):
            failed.append("matched frames are not kernel H's output")
        ref = torch.from_numpy(index)
        want, wi = knn.match_features_knn_plain(st["content"].cpu(), ref, r.k, r.alpha,
                                                r.metric, return_indices=True)
        _check_knn(f"{label} knn vs plain on the CPU", st["content"], ref, r.metric,
                   st["matched"], gi, want, wi)

        ins = [st[k].cpu() for k in ("matched", "f0", "energy")]
        src = st["source"][:1].cpu()
        n_src, L = src.shape[1:]
        pack = n_src + 1 + (-(n_src + 1)) % 8
        packed = torch.cat([src, ins[2][:1, None], src.new_zeros((1, pack - n_src - 1, L))], 1)
        cpu = {}
        for name, (d, dcfg) in cpu_decs.items():
            amps, kern = d.source_net(*ins)
            out = filternet_fused_apply(d.filter_net, dcfg, ins[0][:1], ins[1][:1],
                                        ins[2][:1], packed)
            cpu[name] = dict(amps=amps, noise_kernel=kern, out=out)
        card = dict(amps=st["amps"], noise_kernel=st["noise_kernel"], out=st["out"][:1])
        for key, got in card.items():
            got = got.float().cpu()
            rel = {n: float((got - v[key]).abs().max() / v[key].abs().max())
                   for n, v in cpu.items()}
            rms = {n: float((got - v[key]).square().mean().sqrt() / v[key].square().mean().sqrt())
                   for n, v in cpu.items()}
            tol = SERVING_STAGE_RTOL[key]
            print(f"  {label} {key}{' (row 0)' if key == 'out' else ''}: card vs CPU bf16 "
                  f"{rel['bf16']:.3e} of the peak (tolerance {tol:.3e}), rms {rms['bf16']:.3e}; "
                  f"vs CPU fp32 {rel['fp32']:.3e}, rms {rms['fp32']:.3e}")
            nearer = key not in SERVING_STAGE_NEARER_BF16 or rel["bf16"] < rel["fp32"]
            if not rel["bf16"] <= tol or not nearer:
                failed.append(f"{key} {rel}")
    _check(not failed, f"{label} stages: {failed}")


def phase_second_device(enc, dec, index, wave, fp32_out, serving_b8_out) -> None:
    """With two or more cards: the fp32 B=1 request and the serving B=8
    request (every kernel, A-H) on the last card while card 0 is current,
    each held to card 0's output: every launch must run under its tensor's
    device, on that device's stream."""
    import numpy as np
    import torch

    from tinyvc_tpu_torch.config import serving_config
    from tinyvc_tpu_torch.infer.generator import VoiceConverter

    n = torch.cuda.device_count()
    if n < 2:
        print(f"  second-device check: not applicable, {n} card")
        return
    torch.cuda.set_device(0)
    dev = f"cuda:{n - 1}"
    for cfg, x, want in ((None, wave, fp32_out), (serving_config(), _demo_wave(8), serving_b8_out)):
        vc = VoiceConverter(enc, dec, cfg=cfg, device=dev)
        out = vc.convert(x, torch.from_numpy(index).to(vc.device), PITCH_SHIFT, seed=SEED)
        torch.cuda.synchronize(n - 1)
        diff = float(np.abs(out - want).max())
        label = "fp32 B=1" if cfg is None else "serving B=8"
        print(f"  {label} request on {dev} with cuda:0 current: max |diff| to cuda:0 "
              f"{diff:.3e} (tolerance {WAVE_ATOL:.0e})")
        _check(torch.cuda.current_device() == 0, "the current device changed")
        _check(diff <= WAVE_ATOL, f"{dev} output differs from cuda:0 by {diff}")


# ---------------------------------------------------------------------------
# training: the decoder's pre-join step (kernels I-L beside A, C-F)
# ---------------------------------------------------------------------------

# Tolerances of the gradient kernels against their plain versions:
#  I: the plain version integrates the phase by the JAX package's XLA scheme
#     and kernel I by kernel A's (closer to the float64 truth, as for A): the
#     phases drift apart over the frames and each frame's 480-term sum
#     carries it: 2e-3 of the output's peak (the H100 showed 6.5e-4 at
#     B=16, F=100); the check against the float64 vjp is the tighter gate.
#  J: the same one- to 15-term fp32 sums in another order: 1e-6 of the peak;
#     in bf16 one rounding to bf16 of a sum in another order: one bf16 step.
#  K, L: the exact vjp has jumps where a leaky ReLU's input is 0, and the
#     recomputed pre-activations (fp32 sums in another order than cuDNN's)
#     land on the other side of 0 at a few of the 18M positions of up_4,
#     moving one gradient element by 0.9x its size (on the H100 a float64
#     evaluation of the recomputed chain agreed with the kernel's but
#     downstream of such flips). So the full-width
#     shapes are held by each output's relative L2 error, fp32 1e-3 (the
#     CPU tests' per-leaf bound for the step), bf16 2**-5 (roundings to bf16
#     that land one step apart move the masks they feed), and a ragged
#     small shape, where no flip has room, by the max error: fp32 1e-5 and
#     bf16 2**-7 of the peak.
GRAD_TOL = {"oscillator_grad": 2e-3, "resample_grad": 1e-6, "resample_grad_bf16": 2.0**-8}
CHAIN_GRAD_RTOL = {"fp32": (1e-3, 1e-5), "bf16": (2.0**-5, 2.0**-7)}  # (rel L2, max of peak)
# The full-width step, kernel path against plain path, under the log-mel
# loss (the multi-scale STFT loss's gradient moves by percents under a 1e-7
# change of its input, tests/test_torch_train_unet.py::
# test_ms_stft_gradient_is_chaotic): the losses within 1e-4 relative; the
# gradient leaves within the CPU tests' 1e-3 relative norm at the median.
# Leaf by leaf 1e-3 is below the full-width step's own noise floor: the plain
# path against itself with the U-Net's source moved by 1e-7 moves the worst
# leaf by 3.0e-3 (leaky ReLUs flipped by a rounding; the H100, ROADMAP.md
# §3), so each leaf is held within the larger of 1e-3 and twice that
# floor, measured in the same run.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
STEP_FLOOR_FACTOR = 2.0
# The fused-MRD post-join step against the conv-form one (same state, fp32):
# loss_g and loss_d within 2e-4 relative, JAX's own bound for the pair
# (tests/test_mrd_fused.py:236-241).
POSTJOIN_FUSED_RTOL = 2e-4
TRAIN_STEPS, TRAIN_JOIN = 10, 5  # the CLI: steps 1-5 pre-join, 6-10 post-join
FUSED_STEPS, FUSED_JOIN = 6, 2  # the fused-MRD run: steps 1-2 pre-join, 3-6 post-join
TRAIN_TIMED_FROM = 2  # warm pre-join steps: those after the first two


def _rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() / max(float(want.double().norm()), 1e-30))


def _demo_windows(n: int = 16, length: int = 48000):
    """``n`` two-second windows at staggered offsets, half from
    `demo/two_speaker/source_A.wav`, half from `target_rendition_B.wav`,
    ``[n, length]`` fp32 numpy."""
    import numpy as np

    from tinyvc_tpu_torch.utils.audio_io import load_audio

    demo = os.path.join(ROOT, "demo", "two_speaker")
    rows = []
    for name in ("source_A.wav", "target_rendition_B.wav"):
        wave = load_audio(os.path.join(demo, name))
        step = (wave.shape[0] - length) // (n // 2 - 1)
        rows += [wave[i * step:i * step + length] for i in range(n // 2)]
    return np.stack(rows).astype(np.float32)


def phase_train_kernels(results: dict, rng, dev) -> None:
    """Kernels I-L against their plain versions at the training step's
    full-width shapes (B=16, 2 s), fp32 and with bf16 operands, each also at
    a ragged small shape; one row per kernel and precision, summing the
    calls of one step, timed at the full-width shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tinyvc_tpu_torch.infer.generator import exact_fp32
    from tinyvc_tpu_torch.kernels import filter_stage as fs
    from tinyvc_tpu_torch.kernels import oscillator as osc
    from tinyvc_tpu_torch.kernels import resample as rs
    from tinyvc_tpu_torch.utils.weights import decoder_from_jax, load_npz, pack_filter_net

    kernels_dir = "tinyvc_tpu_torch/kernels/csrc"
    B, F_, H1, L = 16, 100, 15, 48000

    def row(name, source, replaces, err, ms, plain_ms, bounds, library_ms=None):
        bound_ms, bound_by = _sum_bounds(bounds)
        results[name] = dict(name=name, route="cuda", source=f"{kernels_dir}/{source}",
                             replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")

    def randn(*shape, dt=torch.float32, scale=0.5):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev, dt)

    with exact_fp32():
        # I: the oscillator's amplitude gradient at [16, 15, 48000]
        errs = []
        for b, nf in ((B, F_), (3, 37)):
            f0 = torch.from_numpy(rng.uniform(80.0, 320.0, (b, nf)).astype(np.float32)).to(dev)
            f0[0, 5:15] = 0.0
            g = randn(b, H1, nf * 480, scale=1.0)
            got = osc.oscillator_amps_grad(f0, g)
            want = osc.oscillator_amps_grad_plain(f0, g)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            peak = float(want.abs().max())
            truth = _osc_amps_grad_truth(f0.cpu().numpy(), g.cpu().numpy())
            e_k = float(np.abs(got.cpu().numpy() - truth).max())
            e_p = float(np.abs(want.cpu().numpy() - truth).max())
            tol = GRAD_TOL["oscillator_grad"] * peak
            print(f"  oscillator_grad B={b} F={nf}: max_abs_err {err:.3e} (tolerance {tol:.3e}); "
                  f"vs the float64 vjp kernel {e_k:.3e}, plain {e_p:.3e}")
            _check(err <= tol, f"oscillator_grad B={b}: error {err} > {tol}")
            _check(e_k <= 1.5 * e_p, f"oscillator_grad off the float64 vjp: {e_k} vs {e_p}")
            errs.append(err)
            if b == B:
                main_i = (f0, g)
        f0, g = main_i
        # the bytes: g read once, f0 read, the gradient written; ~12 fp32
        # operations per element of g (phase, wrap, sin, gains, 3 products)
        row("oscillator_grad", "oscillator.cu", "tinyvc_tpu/ops/pallas/oscillator.py:311",
            max(errs), _cuda_ms(lambda: osc.oscillator_amps_grad(f0, g)),
            _cuda_ms(lambda: osc.oscillator_amps_grad_plain(f0, g)),
            [_bound(4.0 * (g.numel() + f0.numel() + B * F_ * H1), 12.0 * g.numel())])

        # J: the four resamples of the step: down_1 (/5 on 24 channels),
        # down_2 (/4 on 48), up_3 (x4 on 48), up_4 (x5 on 24)
        for dt, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            isz = 2 if sfx else 4
            acc = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bounds=[])
            for rows, T, f, up in ((B * 24, L, 5, False), (B * 48, L // 5, 4, False),
                                   (B * 48, 2400, 4, True), (B * 24, 9600, 5, True),
                                   (5, 37, 3, True), (5, 111, 4, False)):
                n_g = T * f if up else T // f
                g = randn(rows, n_g, dt=dt, scale=1.0)
                plain = rs.upsample_linear_grad_plain if up else rs.downsample_linear_grad_plain
                got, want = rs.resample_grad(g, T, f, up).float(), plain(g, T, f).float()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = GRAD_TOL["resample_grad" + sfx] * float(want.abs().max())
                print(f"  resample_grad{sfx} {'up' if up else 'down'} {rows}x{T} f={f}: "
                      f"max_abs_err {err:.3e} (tolerance {tol:.3e})")
                _check(err <= tol, f"resample_grad{sfx}: error {err} > {tol}")
                acc["err"] = max(acc["err"], err)
                if rows < 100:
                    continue
                acc["ms"] += _cuda_ms(lambda: rs.resample_grad(g, T, f, up))
                acc["plain"] += _cuda_ms(lambda: plain(g, T, f))
                if up:  # the transpose of a tent upsampling: a strided tent conv
                    w = torch.from_numpy(np.ascontiguousarray(_tent_taps(f))).to(dev, dt)
                    lib = lambda: F.conv1d(g[:, None], w[None, None], stride=f, padding=f)
                else:  # the transpose of a decimation: a strided transposed conv
                    taps = [1.0] if f % 2 else [0.5, 0.5]
                    w = torch.tensor(taps, device=dev, dtype=dt)
                    lib = lambda: F.conv_transpose1d(g[:, None], w[None, None], stride=f)
                acc["lib"] += _cuda_ms(lib)
                acc["bounds"].append(_bound(isz * (g.numel() + rows * T), 0.0))
            row("resample_grad" + sfx, "resample.cu", "tinyvc_tpu/ops/pallas/resample.py:268",
                acc["err"], acc["ms"], acc["plain"], acc["bounds"], acc["lib"])

        # K and L with the two-speaker decoder's packed weights
        dec = decoder_from_jax(load_npz(os.path.join(ROOT, "models", "two_speaker",
                                                     "decoder_B.npz"))).to(dev)
        w = pack_filter_net(dec.filter_net, 24)
        for bf16 in (False, True):
            dt, sfx = (torch.bfloat16, "_bf16") if bf16 else (torch.float32, "")
            isz = 2 if bf16 else 4
            peak_flops = BF16_FLOPS if bf16 else FP32_FLOPS
            rel_tol, max_tol = CHAIN_GRAD_RTOL["bf16" if bf16 else "fp32"]

            def check(name, case, kernel, plain, full):
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                errs = [(float((a - b).abs().max()), float(b.abs().max()), _rel_l2(a, b))
                        for a, b in zip(got, want)]
                worst_rel = max(e[2] for e in errs)
                worst_max = max(e[0] / max(e[1], 1e-30) for e in errs)
                print(f"  {name}{sfx} {case}: relative L2 {worst_rel:.2e}, max {worst_max:.2e} "
                      f"of the peak (tolerance {'L2 %.0e' % rel_tol if full else 'max %.0e' % max_tol})")
                if full:
                    _check(worst_rel <= rel_tol, f"{name}{sfx} {case}: L2 {worst_rel} > {rel_tol}")
                else:
                    _check(worst_max <= max_tol, f"{name}{sfx} {case}: max {worst_max} > {max_tol}")
                return max(e[0] for e in errs)

            acc = {k: dict(err=0.0, ms=0.0, plain=0.0, bounds=[]) for k in ("up", "down")}
            # K: up_2 [96 -> 48, 2400], up_3 [48 -> 24, 9600], up_4 [24 -> 1 folded, 48000]
            for i, (b, T) in ((2, (B, 2400)), (3, (B, 9600)), (4, (B, L)), (4, (2, 777))):
                wu = w.up[i]
                C = wu[0].shape[1]
                fold = i == 4
                co = 1 if fold else wu[4].shape[0]
                xu, cond, gy = randn(b, C, T, dt=dt), randn(b, C, T, dt=dt), randn(b, co, T, scale=1.0)
                args = (xu, cond, *wu[:6], gy, 7 if fold else 0, wu[6] if fold else None)
                full = b == B
                err = check("up_chain_grad", f"up_{i} B={b} [{C} -> {co}, {T}]",
                            lambda: fs.upsample_chain_grad(*args),
                            lambda: fs.upsample_chain_grad_plain(*args), full)
                a = acc["up"]
                a["err"] = max(a["err"], err)
                if full:
                    a["ms"] += _cuda_ms(lambda: fs.upsample_chain_grad(*args))
                    a["plain"] += _cuda_ms(lambda: fs.upsample_chain_grad_plain(*args), reps=5)
                    # the recomputed chain (32 C^2 per sample), each conv's and
                    # FiLM's transpose and weight gradient (64 C^2), the output
                    # 1x1's or folded conv's three products
                    k5 = 7 if fold else co
                    a["bounds"].append(_bound(isz * 2 * b * C * T + 4 * b * T * (co + 2 * C),
                                              96.0 * b * T * C * C + 6.0 * b * T * k5 * C,
                                              peak_flops))
            # L: the stem [24 (17) -> 24, 48000], down_1 [24 -> 48, 9600],
            # down_2 [48 -> 96, 2400]
            for case, b, T in (("stem", B, L), ("stem", 2, 777)):
                x = randn(b, 24, T, dt=dt)
                x[:, 17:] = 0.0
                gy = randn(b, w.stem[0].shape[0], T, scale=1.0)
                full = b == B
                err = check("down_chain_grad", f"stem B={b} [24(17) -> 24, {T}]",
                            lambda: fs.conv3_grad(x, *w.stem, gy),
                            lambda: fs.conv3_grad_plain(x, *w.stem, gy), full)
                a = acc["down"]
                a["err"] = max(a["err"], err)
                if full:
                    a["ms"] += _cuda_ms(lambda: fs.conv3_grad(x, *w.stem, gy))
                    a["plain"] += _cuda_ms(lambda: fs.conv3_grad_plain(x, *w.stem, gy), reps=5)
                    a["bounds"].append(_bound(isz * b * 24 * T + 4 * b * T * (24 + 24),
                                              12.0 * b * T * 17 * 24, peak_flops))
            for i, b, T in ((0, B, 9600), (1, B, 2400), (0, 2, 333)):
                wd = w.down[i]
                co, cin = wd[0].shape
                z, gy = randn(b, cin, T, dt=dt), randn(b, co, T, scale=1.0)
                full = b == B
                err = check("down_chain_grad", f"down_{i + 1} B={b} [{cin} -> {co}, {T}]",
                            lambda: fs.downsample_chain_grad(z, *wd, gy),
                            lambda: fs.downsample_chain_grad_plain(z, *wd, gy), full)
                a = acc["down"]
                a["err"] = max(a["err"], err)
                if full:
                    a["ms"] += _cuda_ms(lambda: fs.downsample_chain_grad(z, *wd, gy))
                    a["plain"] += _cuda_ms(lambda: fs.downsample_chain_grad_plain(z, *wd, gy),
                                           reps=5)
                    a["bounds"].append(_bound(isz * b * cin * T + 4 * b * T * (co + cin),
                                              b * T * (36.0 * cin * cin + 16.0 * cin * co),
                                              peak_flops))
            for key, name, replaces in (
                    ("up", "up_chain_grad", "tinyvc_tpu/ops/pallas/filter_stage.py:1031"),
                    ("down", "down_chain_grad", "tinyvc_tpu/ops/pallas/filter_stage.py:1266")):
                a = acc[key]
                row(name + sfx, "filter_stage_bwd.cu", replaces, a["err"], a["ms"], a["plain"],
                    a["bounds"])


# Kernels M, N, O against their plain versions at the post-join step's
# shapes (B=16, the 8000-sample crop, the four resolutions). M and N in fp32,
# relative to each output's peak: M sums up to 3840 products per output in
# another order than the plain version's einsum, and each layer reads the
# kernel's own previous output (the bound JAX holds its kernel to, 2e-5); N
# sums the transposed products (3e-5, JAX's bound for its vjp). M and N in
# bf16 (relative L2): both sides round the same operands to bf16 and sum in
# fp32 in other orders; a sum that straddles a bf16 rounding stores one bf16
# step away and the step carries into the next layers. The CPU test holds the
# plain chain to JAX's bf16 kernel at 5e-3 (it measured <= 3.0e-3, JAX's own
# bf16 run is up to 8.5e-3 from its fp32 run); the same 5e-3 here. O sums up
# to ~2e5 products per weight and its db of the one-channel post layer is one
# number, a sum of dy with cancellation: relative to that number's own value
# (its "peak") an fp32 reordering measured 2.37e-5 on one draw (bound 3e-5),
# 6.9e-7 on another. So O, in both precisions (the operands are the same
# values on both sides, the products exact in fp32), is held element by
# element to 1e-5 of the sum of its terms' magnitudes, sum |x| |dy| (sum |dy|
# for db), the scale an fp32 sum's rounding error is proportional to.
MRD_TOL = {"fp32": 2e-5, "fp32_grad": 3e-5, "bf16": 5e-3, "sum": 1e-5}
MRD_T, MRD_B = 8000, 16
MRD_CALLS_PER_STEP = {"mrd_fwd": 8, "mrd_dx": 12, "mrd_dw": 12}  # per resolution x crops


def _mrd_flops(plan, B: int) -> float:
    """The dense conv chain's products: 2 * B * cout * (valid outputs) *
    cin * kh * kw over the layers (the plane-major layout also computes
    masked halo rows, which the bound does not count)."""
    return sum(2.0 * B * lp.cout * plan.valid_count(i) * lp.cin * lp.kh * lp.kw
               for i, lp in enumerate(plan.layers))


def _mrd_setup(rng, dev, res: int, B: int, T: int, widths=(32, 256, 4)):
    """(plan, spec [B, 1, S0*(G0+4)*Wp] fp32, effective weights, biases, the
    dense conv chain's (spec [B, 1, bins, W], weights OIHW)) for one
    resolution: a random wave's magnitude spectrogram; weights
    U(+-1/sqrt(fan_in)) (flax's init, where g = |v| makes them v), biases
    U(+-0.1)."""
    import numpy as np
    import torch

    from tinyvc_tpu_torch.dsp.stft import stft_magnitude
    from tinyvc_tpu_torch.ops.mrd_planes import make_plan, pack_spec_planes

    plan = make_plan(res, T, *widths)
    wave = torch.from_numpy((0.3 * rng.standard_normal((B, T))).astype(np.float32)).to(dev)
    spec = stft_magnitude(wave, 4 * res, res, grad_safe=True).transpose(1, 2)  # [B, bins, W]
    spec_pm = pack_spec_planes(spec, plan).reshape(B, 1, -1).contiguous()
    ws, bs = [], []
    for lp in plan.layers:
        bound = 1.0 / math.sqrt(lp.kh * lp.kw * lp.cin)
        ws.append(torch.from_numpy(rng.uniform(-bound, bound, (lp.kh, lp.kw, lp.cin, lp.cout))
                                   .astype(np.float32)).to(dev))
        bs.append(torch.from_numpy(rng.uniform(-0.1, 0.1, lp.cout).astype(np.float32)).to(dev))
    return plan, spec_pm, ws, bs, spec[:, None].contiguous()


def _conv_chain(x, ws, bs):
    """The MRD's conv form (the "lax" lowering) by ``F.conv2d``: the
    library call beside M, N and O."""
    import torch.nn.functional as F

    outs = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        k = w.shape[0]
        stride, pad = (2, 1) if i < len(ws) - 1 else (1, 1), ((k - 1) // 2, 1)
        x = F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride, padding=pad)
        outs.append(x)
    return outs


def phase_mrd_kernels(results: dict, rng, dev) -> None:
    """Kernels M, N, O against their plain versions at the post-join step's
    shapes, all four resolutions, fp32 and bf16, and at a ragged small shape
    (B=3, T=2400, small widths); one row per kernel and precision summing one
    call per resolution (one crop), timed. Library: the conv chain by
    ``F.conv2d`` (cuDNN, TF32 off) forward for M, its autograd backward to
    the spectrogram for N and to the weights and biases for O."""
    import numpy as np
    import torch

    from tinyvc_tpu_torch.infer.generator import exact_fp32
    from tinyvc_tpu_torch.kernels import mrd

    def err(got, want, bf16):
        got, want = got.double(), want.double()
        if bf16:
            return _rel_l2(got, want)
        return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))

    with exact_fp32():
        for bf16 in (False, True):
            dt, sfx = (torch.bfloat16, "_bf16") if bf16 else (torch.float32, "")
            isz = 2 if bf16 else 4
            peak = BF16_FLOPS if bf16 else FP32_FLOPS
            acc = {k: dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bounds=[])
                   for k in ("mrd_fwd", "mrd_dx", "mrd_dw")}
            cases = [(r, MRD_B, MRD_T, (32, 256, 4)) for r in (32, 64, 128, 256)]
            cases += [(64, 3, 2400, (4, 16, 2))]
            for res, B, T, widths in cases:
                full = B == MRD_B
                plan, spec_pm, ws, bs, dense = _mrd_setup(rng, dev, res, B, T, widths)
                spec = spec_pm.to(dt)
                got = mrd.mrd_forward(spec, ws, bs, plan)
                want = mrd.mrd_forward_plain(spec, ws, bs, plan)
                cots = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
                        .to(dev, dt) for o in want]
                gdx = mrd.mrd_dx(cots, ws, plan)
                wdx = mrd.mrd_dx_plain(cots, ws, plan)
                xs = [spec] + want[:-1]
                gdw = mrd.mrd_dw(xs, wdx[1], plan)
                wdw = mrd.mrd_dw_plain(xs, wdx[1], plan)
                # the magnitudes each dW and db element sums: sum |x| |dy|, sum |dy|
                mag = mrd.mrd_dw_plain([x.float().abs() for x in xs],
                                       [d.float().abs() for d in wdx[1]], plan)
                torch.cuda.synchronize()
                tol_f = MRD_TOL["bf16" if bf16 else "fp32"]
                tol_g = MRD_TOL["bf16" if bf16 else "fp32_grad"]
                names = [f"dW{i}" for i in range(len(plan.layers))] + [
                    f"db{i}" for i in range(len(plan.layers))]
                o_err = {n: float(((a - b).abs() / m.clamp_min(1e-30)).max())
                         for n, a, b, m in zip(names, gdw[0] + gdw[1], wdw[0] + wdw[1],
                                               mag[0] + mag[1])}
                o_peak = max(err(a, b, False) for a, b in zip(gdw[0] + gdw[1], wdw[0] + wdw[1]))
                o_worst = max(o_err, key=o_err.get)
                e = {"mrd_fwd": max(err(a, b, bf16) for a, b in zip(got, want)),
                     "mrd_dx": max(err(a, b, bf16) for a, b in zip([gdx[0]] + gdx[1],
                                                                   [wdx[0]] + wdx[1])),
                     "mrd_dw": o_err[o_worst]}
                absmax = {"mrd_fwd": max(float((a.float() - b.float()).abs().max())
                                         for a, b in zip(got, want)),
                          "mrd_dx": float((gdx[0].float() - wdx[0].float()).abs().max()),
                          "mrd_dw": max(float((a - b).abs().max())
                                        for a, b in zip(gdw[0] + gdw[1], wdw[0] + wdw[1]))}
                kind = "relative L2" if bf16 else "max of the peak"
                print(f"  mrd{sfx} r={res} B={B} T={T} widths {widths}: {kind} M "
                      f"{e['mrd_fwd']:.2e}, N {e['mrd_dx']:.2e} (tolerance {tol_f:.0e} / "
                      f"{tol_g:.0e}); O {e['mrd_dw']:.2e} of the sum of |terms| at {o_worst} "
                      f"(tolerance {MRD_TOL['sum']:.0e}; max of each output's peak "
                      f"{o_peak:.2e})")
                _check(e["mrd_fwd"] <= tol_f, f"mrd_fwd{sfx} r={res}: {e['mrd_fwd']} > {tol_f}")
                _check(e["mrd_dx"] <= tol_g, f"mrd_dx{sfx} r={res}: {e['mrd_dx']} > {tol_g}")
                _check(e["mrd_dw"] <= MRD_TOL["sum"],
                       f"mrd_dw{sfx} r={res}: {e['mrd_dw']} > {MRD_TOL['sum']}")
                for k in acc:
                    acc[k]["err"] = max(acc[k]["err"], absmax[k])
                if not full:
                    continue
                flops = _mrd_flops(plan, B)
                maps = sum(o.numel() for o in want)
                wbytes = 4.0 * sum(w.numel() + b.numel() for w, b in zip(ws, bs))
                acc["mrd_fwd"]["bounds"].append(
                    _bound(isz * (spec.numel() + maps) + wbytes, flops, peak))
                acc["mrd_dx"]["bounds"].append(
                    _bound(isz * (2 * maps + spec.numel()) + wbytes, flops, peak))
                acc["mrd_dw"]["bounds"].append(
                    _bound(isz * (spec.numel() + 2 * maps) + wbytes, flops, peak))
                for k, fn, plain in (
                        ("mrd_fwd", lambda: mrd.mrd_forward(spec, ws, bs, plan),
                         lambda: mrd.mrd_forward_plain(spec, ws, bs, plan)),
                        ("mrd_dx", lambda: mrd.mrd_dx(cots, ws, plan),
                         lambda: mrd.mrd_dx_plain(cots, ws, plan)),
                        ("mrd_dw", lambda: mrd.mrd_dw(xs, wdx[1], plan),
                         lambda: mrd.mrd_dw_plain(xs, wdx[1], plan))):
                    acc[k]["ms"] += _cuda_ms(fn)
                    acc[k]["plain"] += _cuda_ms(plain, reps=5, warmup=1)
                # library: the dense conv chain in the operand dtype
                x = dense.to(dt).requires_grad_()
                wl = [w.to(dt).requires_grad_() for w in ws]
                bl = [b.to(dt).requires_grad_() for b in bs]
                outs = _conv_chain(x, wl, bl)
                dcots = [torch.randn_like(o) for o in outs]
                with torch.no_grad():
                    acc["mrd_fwd"]["lib"] += _cuda_ms(lambda: _conv_chain(x.detach(), wl, bl))
                acc["mrd_dx"]["lib"] += _cuda_ms(lambda: torch.autograd.grad(
                    outs, [x], dcots, retain_graph=True))
                acc["mrd_dw"]["lib"] += _cuda_ms(lambda: torch.autograd.grad(
                    outs, wl + bl, dcots, retain_graph=True))
                del outs, dcots
            for k, name, replaces in (
                    ("mrd_fwd", "mrd_fwd", "tinyvc_tpu/ops/pallas/mrd.py:178"),
                    ("mrd_dx", "mrd_dx", "tinyvc_tpu/ops/pallas/mrd.py:356"),
                    ("mrd_dw", "mrd_dw", "tinyvc_tpu/ops/pallas/mrd.py:385")):
                a = acc[k]
                bound_ms, bound_by = _sum_bounds(a["bounds"])
                results[name + sfx] = dict(
                    name=name + sfx, route="cuda", source="tinyvc_tpu_torch/kernels/csrc/mrd.cu",
                    replaces=replaces, max_abs_err=a["err"], ms=a["ms"], plain_ms=a["plain"],
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=a["lib"])
                print(f"  {name}{sfx} (one crop, four resolutions; {MRD_CALLS_PER_STEP[k]} calls "
                      f"a step): kernel {a['ms']:.4f} ms, plain {a['plain']:.4f} ms, library "
                      f"{a['lib']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")


def _tent_taps(f: int):
    """The tent upsampling's 3f taps in conv order (a strided conv with them
    is the upsampling's transpose, up to the clamped ends)."""
    import numpy as np

    a = (np.arange(f) + 0.5) / f - 0.5
    k = np.zeros(3 * f, np.float32)
    for j in range(f):
        k[f + j] += 1.0 - abs(a[j])
        if a[j] < 0:
            k[j] += -a[j]  # this output's share of the previous sample
        if a[j] > 0:
            k[2 * f + j] += a[j]
    return k


def _osc_amps_grad_truth(f0, g, frame=480, sr=24000, fmin=20.0):
    """float64 vjp of the oscillator bank in its amplitudes, ``[B, F, H1]``."""
    import numpy as np

    B, F_ = f0.shape
    L = F_ * frame
    src = np.clip((np.arange(L) + 0.5) / frame - 0.5, 0, F_ - 1)
    j = np.floor(src).astype(int)
    j1 = np.minimum(j + 1, F_ - 1)
    fr = src - j
    f0w = f0.astype(np.float64)[:, j] * (1 - fr) + f0.astype(np.float64)[:, j1] * fr
    phase = np.cumsum(f0w / sr, axis=1)
    uv = (f0 > fmin).astype(np.float64)
    uv = uv[:, j] * (1 - fr) + uv[:, j1] * fr
    out = np.zeros((B, F_, g.shape[1]))
    for h in range(g.shape[1]):
        m = g[:, h].astype(np.float64) * np.sin(2 * np.pi * np.mod(phase * (h + 1), 1.0)) * uv
        for b in range(B):
            out[b, :, h] = (np.bincount(j, m[b] * (1 - fr), F_) + np.bincount(j1, m[b] * fr, F_))
    return out


def _train_wrappers():
    """(name in the kernels line, wrapper, bf16 counter) of every kernel the
    training step runs."""
    from tinyvc_tpu_torch.kernels import filter_stage as fs
    from tinyvc_tpu_torch.kernels import oscillator as osc
    from tinyvc_tpu_torch.kernels import resample as rs

    return (("oscillator", osc.oscillator_bank), ("oscillator_grad", osc.oscillator_amps_grad),
            ("upsample", rs.upsample_linear), ("downsample", rs.downsample_linear),
            ("resample_grad", rs.resample_grad), ("stem", fs.conv3),
            ("down_chain", fs.downsample_chain), ("up_chain", fs.upsample_chain),
            ("stem_grad", fs.conv3_grad), ("down_chain_grad", fs.downsample_chain_grad),
            ("up_chain_grad", fs.upsample_chain_grad))


def _reset_train_counts() -> None:
    for _, w in _train_wrappers():
        w.launches = 0
        if hasattr(w, "launches_bf16"):
            w.launches_bf16 = 0


def _train_counts() -> dict:
    """Launches since the reset, by kernel (the stem counts with the down
    chains, as in the forward rows): ``{name: (all, of them bf16)}``."""
    counts = {}
    for name, w in _train_wrappers():
        name = {"stem": "down_chain", "stem_grad": "down_chain_grad"}.get(name, name)
        n, n16 = counts.get(name, (0, 0))
        counts[name] = (n + w.launches, n16 + getattr(w, "launches_bf16", 0))
    return counts


class _PlainDispatch:
    """A stand-in for `kernels/build.py` in the given kernel modules that
    sends CUDA tensors to the plain versions: the plain path of the step
    comparison (never the main path)."""

    def __init__(self, *modules):
        self.modules = modules

    def __enter__(self):
        import types

        from tinyvc_tpu_torch.kernels import build

        proxy = types.SimpleNamespace(**{k: getattr(build, k) for k in dir(build)
                                         if not k.startswith("__")})
        proxy.on_cpu = lambda *t: True
        self.saved = [m.build for m in self.modules]
        for m in self.modules:
            m.build = proxy
        return self

    def __exit__(self, *exc):
        for m, b in zip(self.modules, self.saved):
            m.build = b


def phase_train_step(card: str) -> dict:
    """One full-width pre-join step (B=16, 2 s, the two-speaker encoder and
    decoder) in fp32, the kernel path against the plain path on the same
    state, wave and key: the plain path runs every kernel of the U-Net and
    the resamples as its plain version on the card; the oscillator pair (A,
    I) runs in both, since its plain versions integrate the phase by the
    XLA scheme, which differs by design and moves a voiced step's gradients
    more than the bound (A and I are held to their plain versions above).
    Returns the fp32 launches of the kernel-path step."""
    import numpy as np
    import torch

    from tinyvc_tpu_torch.config import DecoderConfig, TinyVCConfig
    from tinyvc_tpu_torch.kernels import filter_stage as fs
    from tinyvc_tpu_torch.kernels import resample as rs
    from tinyvc_tpu_torch.models.decoder import Decoder
    from tinyvc_tpu_torch.train import decoder_train as dt
    from tinyvc_tpu_torch.train.loop import load_encoder
    from tinyvc_tpu_torch.utils import prng
    from tinyvc_tpu_torch.utils.weights import load_npz, train_state_from_jax

    models = os.path.join(ROOT, "models", "two_speaker")
    cfg = TinyVCConfig(decoder=DecoderConfig(use_fused_filter_train="on"))
    enc = load_encoder(os.path.join(models, "encoder_B.npz"), cfg, SEED, "cuda")
    state = train_state_from_jax(load_npz(os.path.join(models, "decoder_B.npz")), cfg.decoder,
                                 cfg.audio, "cuda")
    wave = torch.from_numpy(_demo_windows()).cuda()
    key = prng.split(prng.prng_key(SEED + 2))[1]
    step = dt.make_train_step(cfg, d_join=False, spec_loss_type="mel", dtype_name="float32")
    _reset_train_counts()
    t0 = time.perf_counter()
    loss_k, met_k, g_k = step.loss_and_grads(state, enc, wave, key)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = {k: n for k, (n, _) in _train_counts().items()}
    print(f"  kernel path: {t_kernel * 1e3:.1f} ms (cold), launches {launches}")
    for name, n in launches.items():
        _check(n > 0, f"{name} was not launched in the fp32 step")
    t0 = time.perf_counter()
    with _PlainDispatch(fs, rs):
        loss_p, met_p, g_p = step.loss_and_grads(state, enc, wave, key)
    torch.cuda.synchronize()
    print(f"  plain path: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for name in ("loss_spec", "loss_dsp"):
        a, b = float(met_k[name]), float(met_p[name])
        print(f"  {name}: kernel path {a:.6f}, plain path {b:.6f}, relative "
              f"{abs(a - b) / abs(b):.2e} (tolerance {STEP_LOSS_RTOL:.0e})")
        _check(abs(a - b) <= STEP_LOSS_RTOL * abs(b), f"{name} differs")
    errs = _leaf_errors(g_k, g_p)
    # the plain path against itself with the U-Net's source moved by 1e-7
    # (relative): how far a leaky ReLU flipped by a rounding moves each leaf
    orig = Decoder.dsp_train
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def nudged(self, *a):
        src = orig(self, *a)
        return src * (1.0 + 1e-7 * torch.randn(src.shape, device=src.device, generator=gen))

    Decoder.dsp_train = nudged
    try:
        with _PlainDispatch(fs, rs):
            _, met_n, g_n = step.loss_and_grads(state, enc, wave, key)
    finally:
        Decoder.dsp_train = orig
    floor = _leaf_errors(g_n, g_p)
    worst = sorted(errs, key=errs.get, reverse=True)
    print(f"  gradient leaves ({len(errs)}): worst relative norm error kernel vs plain "
          + ", ".join(f"{k} {errs[k]:.2e} (plain vs nudged plain {floor[k]:.2e})"
                      for k in worst[:6])
          + f"; median {statistics.median(errs.values()):.2e}, nudged median "
          f"{statistics.median(floor.values()):.2e} (tolerance: median {STEP_GRAD_RTOL:.0e}, "
          f"each leaf max({STEP_GRAD_RTOL:.0e}, {STEP_FLOOR_FACTOR:g} x nudged))")
    _check(statistics.median(errs.values()) <= STEP_GRAD_RTOL, "gradients differ at the median")
    for k, e in errs.items():
        limit = max(STEP_GRAD_RTOL, STEP_FLOOR_FACTOR * floor[k])
        _check(e <= limit, f"gradient of {k} differs by {e} > {limit}")
    # the fp32 step warm (forward and backward, no update): host time and
    # one profiled call
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step.loss_and_grads(state, enc, wave, key)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    kernels, _ = _profile_call(lambda: step.loss_and_grads(state, enc, wave, key))
    print(f"  fp32 step (forward and backward) warm: {statistics.median(times) * 1e3:.3f} ms "
          f"median of 3 ({card})")
    _print_breakdown("fp32 step", kernels, statistics.median(times) * 1e3)
    return launches


def _leaf_errors(got: dict, want: dict) -> dict:
    return {k: _rel_l2(got[k], want[k]) if float(want[k].norm()) > 0 else float(got[k].norm())
            for k in want}


def _mrd_wrappers():
    """(name in the kernels line, wrapper) of kernels M, N and O."""
    from tinyvc_tpu_torch.kernels import mrd

    return (("mrd_fwd", mrd.mrd_forward), ("mrd_dx", mrd.mrd_dx), ("mrd_dw", mrd.mrd_dw))


def _reset_mrd_counts() -> None:
    for _, w in _mrd_wrappers():
        w.launches = w.launches_bf16 = 0


def _mrd_counts() -> dict:
    return {name: (w.launches, w.launches_bf16) for name, w in _mrd_wrappers()}


def phase_postjoin_step(card: str) -> dict:
    """One full-width post-join step (B=16, 2 s, the two-speaker encoder and
    decoder, a discriminator drawn from the seed) in fp32 with the fused
    MRD, under the log-mel loss: the kernel path against the plain path on
    the same state, wave and key (M, N, O and the U-Net's and resamples'
    kernels as their plain versions on the card; the oscillator pair in both,
    as in `phase_train_step`), every loss and every gradient leaf of both
    networks; then the fused-MRD step against the conv-form ("lax") step.
    Returns the fp32 launches of M, N and O in the kernel-path step."""
    import dataclasses

    import torch

    from tinyvc_tpu_torch.config import DecoderConfig, DiscriminatorConfig, TinyVCConfig
    from tinyvc_tpu_torch.kernels import filter_stage as fs
    from tinyvc_tpu_torch.kernels import mrd
    from tinyvc_tpu_torch.kernels import resample as rs
    from tinyvc_tpu_torch.models.decoder import Decoder
    from tinyvc_tpu_torch.models.discriminator import Discriminator
    from tinyvc_tpu_torch.train import decoder_train as dt
    from tinyvc_tpu_torch.train.loop import load_encoder
    from tinyvc_tpu_torch.utils import prng
    from tinyvc_tpu_torch.utils.weights import load_npz, train_state_from_jax

    models = os.path.join(ROOT, "models", "two_speaker")
    cfg = TinyVCConfig(decoder=DecoderConfig(use_fused_filter_train="on"),
                       discriminator=DiscriminatorConfig(mrd_conv_impl="fused"))
    enc = load_encoder(os.path.join(models, "encoder_B.npz"), cfg, SEED, "cuda")
    state = dt.init_state(cfg, SEED + 1, "cuda")
    init = train_state_from_jax(load_npz(os.path.join(models, "decoder_B.npz")), cfg.decoder,
                                cfg.audio, "cuda")
    state.decoder, state.gen_opt = init.decoder, init.gen_opt
    wave = torch.from_numpy(_demo_windows()).cuda()
    key = prng.split(prng.prng_key(SEED + 2))[1]
    step = dt.make_train_step(cfg, d_join=True, spec_loss_type="mel", dtype_name="float32")

    def grads(*out):
        return out[1] | {"loss_g": out[0]}, (
            {f"gen {k}": v for k, v in out[2].items()}
            | {f"disc {k}": v for k, v in out[3].items()})

    _reset_mrd_counts()
    t0 = time.perf_counter()
    met_k, g_k = grads(*step.loss_and_grads(state, enc, wave, key))
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = {k: n for k, (n, _) in _mrd_counts().items()}
    print(f"  kernel path: {t_kernel * 1e3:.1f} ms (cold), launches of M, N, O {launches}")
    for name, n in launches.items():
        _check(n > 0, f"{name} was not launched in the fp32 post-join step")
    t0 = time.perf_counter()
    with _PlainDispatch(fs, rs, mrd):
        met_p, g_p = grads(*step.loss_and_grads(state, enc, wave, key))
    torch.cuda.synchronize()
    print(f"  plain path: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for name in ("loss_spec", "loss_dsp", "loss_adv", "loss_feat", "loss_g", "loss_d"):
        a, b = float(met_k[name]), float(met_p[name])
        print(f"  {name}: kernel path {a:.7f}, plain path {b:.7f}, relative "
              f"{abs(a - b) / abs(b):.2e} (tolerance {STEP_LOSS_RTOL:.0e})")
        _check(abs(a - b) <= STEP_LOSS_RTOL * abs(b), f"{name} differs")
    errs = _leaf_errors(g_k, g_p)
    orig = Decoder.dsp_train
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def nudged(self, *a):
        src = orig(self, *a)
        return src * (1.0 + 1e-7 * torch.randn(src.shape, device=src.device, generator=gen))

    Decoder.dsp_train = nudged
    try:
        with _PlainDispatch(fs, rs, mrd):
            _, g_n = grads(*step.loss_and_grads(state, enc, wave, key))
    finally:
        Decoder.dsp_train = orig
    floor = _leaf_errors(g_n, g_p)
    worst = sorted(errs, key=errs.get, reverse=True)
    for label in ("gen", "disc"):
        e = [v for k, v in errs.items() if k.startswith(label)]
        print(f"  {label} leaves ({len(e)}): median relative norm error {statistics.median(e):.2e}")
    print(f"  gradient leaves ({len(errs)}): worst kernel vs plain "
          + ", ".join(f"{k} {errs[k]:.2e} (nudged plain {floor[k]:.2e})" for k in worst[:6])
          + f"; median {statistics.median(errs.values()):.2e}, nudged median "
          f"{statistics.median(floor.values()):.2e} (tolerance: median {STEP_GRAD_RTOL:.0e}, "
          f"each leaf max({STEP_GRAD_RTOL:.0e}, {STEP_FLOOR_FACTOR:g} x nudged))")
    _check(statistics.median(errs.values()) <= STEP_GRAD_RTOL, "gradients differ at the median")
    for k, e in errs.items():
        limit = max(STEP_GRAD_RTOL, STEP_FLOOR_FACTOR * floor[k])
        _check(e <= limit, f"gradient of {k} differs by {e} > {limit}")
    # the fused MRD against the conv form, same state (identical parameter trees)
    lax_cfg = dataclasses.replace(cfg, discriminator=DiscriminatorConfig())
    lax_disc = Discriminator(lax_cfg.discriminator).cuda()
    lax_disc.load_state_dict(state.discriminator.state_dict())
    lax = dt.make_train_step(lax_cfg, d_join=True, spec_loss_type="mel", dtype_name="float32")
    met_l, _ = grads(*lax.loss_and_grads(dataclasses.replace(state, discriminator=lax_disc),
                                         enc, wave, key))
    for name in ("loss_g", "loss_d"):
        a, b = float(met_k[name]), float(met_l[name])
        print(f"  {name}: fused MRD {a:.7f}, conv form {b:.7f}, relative "
              f"{abs(a - b) / abs(b):.2e} (tolerance {POSTJOIN_FUSED_RTOL:.0e})")
        _check(abs(a - b) <= POSTJOIN_FUSED_RTOL * abs(b), f"{name}: fused MRD vs conv form")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step.loss_and_grads(state, enc, wave, key)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"  fp32 post-join step (forward and backward, fused MRD) warm: "
          f"{statistics.median(times) * 1e3:.3f} ms median of 3 ({card})")
    return launches


def phase_train_cli(card: str, fused_mrd: bool = False) -> dict:
    """Training across the discriminator's join on a cache of the demo
    windows, ``TrainConfig()`` (B=16, 2 s, bf16 operands on the card, the
    TPU's choice), logged every step: ``train_decoder`` through its CLI
    entry (the conv-form MRD, the CLI's), ``TRAIN_STEPS`` steps with
    ``-d-join TRAIN_JOIN``; or, with ``fused_mrd``, `train/loop.py::
    train_decoder` (the function the CLI runs) with ``mrd_conv_impl="fused"``,
    ``FUSED_STEPS`` steps joining at ``FUSED_JOIN``. Warm ms per pre-join and
    post-join step (synchronised; medians of the steps after the first two
    and after the first post-join one), peak memory, one profiled post-join
    step (the last). Returns the launches of the run's bf16 forms."""
    import tempfile

    import numpy as np
    import torch

    from tinyvc_tpu_torch.cli import train_decoder as cli
    from tinyvc_tpu_torch.config import DiscriminatorConfig, TinyVCConfig, TrainConfig
    from tinyvc_tpu_torch.train import decoder_train as dt
    from tinyvc_tpu_torch.train import loop
    from tinyvc_tpu_torch.utils import prng
    from tinyvc_tpu_torch.utils.audio_io import save_wav
    from tinyvc_tpu_torch.utils.checkpoint import CheckpointManager, state_to_tree

    label = "fused-MRD train_decoder" if fused_mrd else "train_decoder CLI"
    steps, join = (FUSED_STEPS, FUSED_JOIN) if fused_mrd else (TRAIN_STEPS, TRAIN_JOIN)
    models = os.path.join(ROOT, "models", "two_speaker")
    times, profiled = [], {}  # times: (post-join, seconds) per step
    origs = {cls: cls.__dict__["__call__"] for cls in (dt.TrainStep, dt.PostJoinStep)}

    def timed(orig):
        def call(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(times) == steps - 1:
                profiled["kernels"] = _profile_call(lambda: orig(self, *a, **k))
                out = profiled["kernels"][1]
            else:
                out = orig(self, *a, **k)
            torch.cuda.synchronize()
            times.append((isinstance(self, dt.PostJoinStep), time.perf_counter() - t0))
            return out
        return call

    cfg = TinyVCConfig(discriminator=DiscriminatorConfig(mrd_conv_impl="fused"),
                       train=TrainConfig(max_steps=steps, discriminator_join=join,
                                         log_interval=1, save_interval=steps))
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache)
        for i, w in enumerate(_demo_windows()):
            save_wav(os.path.join(cache, f"{i}.wav"), w)
            np.save(os.path.join(cache, f"{i}.f0.npy"), np.zeros(100, np.float32))
        ckpt, logs = os.path.join(tmp, "ckpt"), os.path.join(tmp, "logs")
        init = os.path.join(models, "decoder_B.npz")
        enc = os.path.join(models, "encoder_B.npz")
        _reset_train_counts()
        _reset_mrd_counts()
        torch.cuda.reset_peak_memory_stats()
        for cls, orig in origs.items():
            cls.__call__ = timed(orig)
        try:
            if fused_mrd:
                loop.train_decoder(cfg, dataset_dir=cache, encoder_path=enc, ckpt_dir=ckpt,
                                   log_dir=logs, init_decoder=init)
            else:
                cli.main(["--dataset-cache", cache, "-encp", enc, "--init-decoder", init,
                          "-decp", ckpt, "--log-dir", logs, "-step", str(steps), "-d-join",
                          str(join), "--log-interval", "1", "--save-interval", str(steps)])
        finally:
            for cls, orig in origs.items():
                cls.__call__ = orig
        peak = torch.cuda.max_memory_allocated()
        counts = _train_counts()
        if fused_mrd:
            counts |= _mrd_counts()
        with open(os.path.join(logs, "metrics.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        state = torch.load(os.path.join(ckpt, str(steps), "state.pt"), weights_only=False)
        _check(CheckpointManager(ckpt).steps() == [steps], "no checkpoint on disk")
        before = np.load(init)
        moved = [k for k in before.files
                 if not np.array_equal(state[f"gen_params/{k}"], before[k])]
        drawn = {k: v for k, v in state_to_tree(dt.init_state(cfg, SEED + 1)).items()
                 if k.startswith("disc_params/")}
        moved_d = [k for k, v in drawn.items() if not np.array_equal(state[k], v)]
    adv = ("loss/Generator Adversarial", "loss/Feature Matching",
           "loss/Discriminator Adversarial")
    losses = [[r["loss/Spectrogram"], r["loss/DSP"]] + [r[t] for t in adv if t in r]
              for r in lines]
    print(f"  {label}: losses (spec, dsp[, adv, feat, d]) per step: "
          + ", ".join("(" + ", ".join(f"{x:.4f}" for x in ls) + ")" for ls in losses))
    _check(len(lines) == steps and all(np.isfinite(x) for ls in losses for x in ls),
           "non-finite loss")
    _check([len(ls) for ls in losses] == [2] * join + [5] * (steps - join),
           "the post-join steps did not log the adversarial losses")
    skipped = int(state["gen_opt/notfinite_count"]) + int(state["disc_opt/notfinite_count"])
    print(f"  skipped {skipped}; {len(moved)} of {len(before.files)} generator and "
          f"{len(moved_d)} of {len(drawn)} discriminator parameters changed; disc_opt count "
          f"{state['disc_opt/count']}; launches (all, of them bf16) {counts}")
    _check(skipped == 0, f"{skipped} steps skipped")
    _check(len(moved) >= 0.9 * len(before.files), "the generator did not change")
    _check(len(moved_d) >= 0.9 * len(drawn), "the discriminator did not change")
    _check(state["disc_opt/count"] == steps - join, "the discriminator's updates")
    for name, (n, _) in counts.items():
        _check(n > 0, f"{name} was not launched in {label}")
    if not fused_mrd:
        draws = []
        for _ in range(3):  # the host's share: the noise phases drawn by threefry in numpy
            t0 = time.perf_counter()
            prng.uniform(prng.prng_key(SEED), (16, 100, 961), -math.pi, math.pi)
            draws.append(time.perf_counter() - t0)
        print(f"  host: the step's noise phases (16 x 100 x 961 uniform draws, utils/prng.py) "
              f"{statistics.median(draws) * 1e3:.3f} ms median of 3")
    pre = [t for post, t in times if not post]
    post = [t for p, t in times if p]
    warm_pre, warm_post = pre[TRAIN_TIMED_FROM:], post[1:-1]  # the last step ran profiled
    print(f"  {label}: first two steps {pre[0] * 1e3:.1f}, {pre[1] * 1e3:.1f} ms; first "
          f"post-join step {post[0] * 1e3:.1f} ms; peak memory {peak / 2**30:.3f} GiB ({card})")
    for kind, warm in (("pre-join", warm_pre), ("post-join", warm_post)):
        if warm:
            med = statistics.median(warm)
            print(f"  {label}: warm {kind} step median {med * 1e3:.3f} ms over {len(warm)} "
                  f"(min {min(warm) * 1e3:.3f}, max {max(warm) * 1e3:.3f}); B=16 x 2 s, "
                  f"{32.0 / med:.1f} audio-s/s trained ({card})")
    kernels = profiled["kernels"][0]
    _print_breakdown(f"{label} post-join step", kernels, statistics.median(warm_post) * 1e3)
    return {k: n16 for k, (_, n16) in counts.items()}


def _profile_call(fn):
    """(device time by kernel name {name: [ms, count]}, fn's result) of one
    call under torch.profiler."""
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels[evt.name]
            k[0] += evt.time_range.elapsed_us() / 1e3
            k[1] += 1
    return dict(kernels), out


def _print_breakdown(label: str, kernels: dict, wall_ms: float) -> None:
    from collections import defaultdict

    busy = sum(v[0] for v in kernels.values())
    if busy == 0.0:
        print(f"  {label}: the profiler recorded no device time; breakdown not measured")
        return
    print(f"  {label}: device busy {busy:.3f} ms in {sum(v[1] for v in kernels.values())} "
          f"kernels, idle share {1.0 - busy / wall_ms:.3f}")
    groups = defaultdict(float)
    for name, (ms, _) in kernels.items():
        groups[_profile_group(name)] += ms
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {group:38s} {ms:9.3f} ms  {ms / busy:6.1%}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    top {ms:9.3f} ms  x{n:<4d} {name[:100]}")


# Kernel-name fragments -> group for the profile; the first match wins.
# cuDNN's convolutions are implicit GEMMs ("fprop_implicit_gemm",
# "implicit_convolve_sgemm"), so they are matched before plain GEMMs.
PROFILE_GROUPS = (
    ("kernel M (MRD forward)", ("mrd_fwd_kernel",)),
    ("kernel N (MRD dy, dx)", ("mrd_dy_kernel", "mrd_dx_kernel")),
    ("kernel O (MRD dW, db)", ("mrd_dw_partial", "mrd_dw_sum", "mrd_db_kernel")),
    ("kernel I (oscillator gradient)", ("osc_amps_grad",)),
    ("kernel A (oscillator)", ("osc_frame_sums", "osc_synth")),
    ("kernel B (noise)", ("noise_fft", "noise_synth")),  # the FFT design, the DFT one
    ("kernel C (upsample)", ("upsample_linear_kernel",)),
    ("kernel D (downsample)", ("downsample_linear_kernel",)),
    ("kernel E (stem, down chains)", ("down_chain_step",)),
    ("kernel F (up chains)", ("up_chain_step",)),
    ("kernel G (spectrogram)", ("spectrogram_fft", "spectrogram_dft")),
    ("kernel H (kNN)", ("knn_topk", "knn_mean")),
    ("kernel J (resample gradients)", ("upsample_grad_kernel", "downsample_grad_kernel")),
    ("kernel K (up chain gradients)", ("up_grad_",)),
    ("kernel L (stem, down chain gradients)", ("down_grad_",)),
    ("fft", ("fft",)),
    ("convolution", ("fprop", "implicit", "conv")),
    ("gemm", ("gemm",)),
    ("host-to-device copies", ("memcpy htod",)),
)


def _profile_group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise, reductions, device copies"


def phase_profile(card: str, vc, target, wave, batches=(1, 4), label: str = "fp32",
                  requests: int = 5) -> None:
    """Where a warm request's time goes, at each of ``batches``: the median
    host latency of ``requests`` requests (each ends in a synchronise), then
    one request under ``torch.profiler`` with its kernel time by group. Idle
    share = 1 - kernel time of the profiled request / median latency; the
    port runs on one stream, so kernels do not overlap."""
    from collections import defaultdict

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    for B in batches:
        x = wave if B == 1 else np.stack([wave] * B)
        audio_s = B * wave.shape[0] / 24000.0
        for _ in range(2):
            vc.convert(x, target, PITCH_SHIFT, seed=SEED)
        times = []
        for _ in range(requests):
            t0 = time.perf_counter()
            vc.convert(x, target, PITCH_SHIFT, seed=SEED)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(f"  {label} B={B}: warm request median {med * 1e3:.3f} ms over {requests} "
              f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
              f"{audio_s / med:.2f} audio-s/s ({card})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            vc.convert(x, target, PITCH_SHIFT, seed=SEED)
            torch.cuda.synchronize()
        kernels = defaultdict(lambda: [0.0, 0])
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels[evt.name]
                k[0] += evt.time_range.elapsed_us() / 1e3
                k[1] += 1
        busy = sum(v[0] for v in kernels.values())
        if busy == 0.0:
            print(f"  {label} B={B}: the profiler recorded no device time; breakdown not measured")
            continue
        print(f"  {label} B={B}: device busy {busy:.3f} ms in "
              f"{sum(v[1] for v in kernels.values())} "
              f"kernels, idle share {1.0 - busy / (med * 1e3):.3f}")
        groups = defaultdict(float)
        for name, (ms, _) in kernels.items():
            groups[_profile_group(name)] += ms
        for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {group:38s} {ms:9.3f} ms  {ms / busy:6.1%}")
        for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"    top {ms:9.3f} ms  x{n:<4d} {name[:100]}")


def phase_profile_only(card: str) -> None:
    """The profile phase alone: fp32 and serving converters of the
    two-speaker weights, warm requests at B=1 and 4 (fp32), 1 and 8
    (serving), 15 each."""
    import torch

    from tinyvc_tpu_torch.config import serving_config
    from tinyvc_tpu_torch.infer.generator import VoiceConverter
    from tinyvc_tpu_torch.utils.audio_io import load_audio
    from tinyvc_tpu_torch.utils.weights import load_index, load_npz

    models = os.path.join(ROOT, "models", "two_speaker")
    enc = load_npz(os.path.join(models, "encoder_B.npz"))
    dec = load_npz(os.path.join(models, "decoder_B.npz"))
    target = torch.from_numpy(load_index(os.path.join(models, "index_B.npy"))).to("cuda")
    wave = load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))
    vc = VoiceConverter(enc, dec, device="cuda")
    serving = VoiceConverter(enc, dec, cfg=serving_config(), device="cuda")
    phase_profile(card, vc, target, wave, requests=15)
    phase_profile(card, serving, target, wave, batches=(1, 8), label="serving", requests=15)


def main(argv=None) -> int:
    """No arguments: every phase. ``--profile [DIR]``: env, build and the
    profile phase only, of the port in DIR (a checkout of another commit;
    default: this one), for comparing two commits in one call (parent,
    change, change, parent)."""
    global ROOT
    args = sys.argv[1:] if argv is None else argv
    profile_only = bool(args) and args[0] == "--profile"
    if profile_only and len(args) > 1:
        ROOT = os.path.abspath(args[1])
    if not os.path.isdir(os.path.join(ROOT, "tinyvc_tpu_torch")):
        print("chip_smoke.py needs the repository around it (tinyvc_tpu_torch/)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py runs on a GPU", file=sys.stderr)
        return 1
    if profile_only:
        print(f"profile of {ROOT}")
        card = phase_env()
        phase_build()
        phase_profile_only(card)
        return 0

    t_all = time.perf_counter()
    t0 = _phase("env")
    card = phase_env()
    _done("env", t0)
    t0 = _phase("build")
    phase_build()
    _done("build", t0)
    t0 = _phase("kernels")
    kernels = phase_kernels()
    _done("kernels", t0)
    t0 = _phase("convert")
    launches, ctx, serving = phase_convert(card)
    _done("convert", t0)
    t0 = _phase("profile")
    phase_profile(card, *ctx)
    phase_profile(card, serving, *ctx[1:], batches=(1, 8), label="serving")
    _done("profile", t0)
    t0 = _phase("train")
    import numpy as np

    phase_train_kernels(kernels, np.random.default_rng(1), torch.device("cuda"))
    step_launches = phase_train_step(card)
    _done("train", t0)
    t0 = _phase("post-join")
    phase_mrd_kernels(kernels, np.random.default_rng(2), torch.device("cuda"))
    join_launches = phase_postjoin_step(card)
    cli_launches = phase_train_cli(card)
    fused_launches = phase_train_cli(card, fused_mrd=True)
    for name in ("oscillator_grad", "resample_grad", "up_chain_grad", "down_chain_grad"):
        launches[name] = step_launches[name]
        if name != "oscillator_grad":
            launches[name + "_bf16"] = cli_launches[name]
    for name in ("mrd_fwd", "mrd_dx", "mrd_dw"):
        launches[name] = join_launches[name]
        launches[name + "_bf16"] = fused_launches[name]
    _done("post-join", t0)
    print(f"== total: {time.perf_counter() - t_all:.2f} s")

    rows = []
    for key in ("oscillator", "noise", "upsample", "downsample", "down_chain", "up_chain",
                "spectrogram", "knn", "upsample_bf16", "downsample_bf16", "down_chain_bf16",
                "up_chain_bf16", "oscillator_grad", "resample_grad", "resample_grad_bf16",
                "up_chain_grad", "up_chain_grad_bf16", "down_chain_grad",
                "down_chain_grad_bf16", "mrd_fwd", "mrd_dx", "mrd_dw", "mrd_fwd_bf16",
                "mrd_dx_bf16", "mrd_dw_bf16"):
        r = kernels[key]
        rows.append({k: r[k] for k in ("name", "route", "source", "replaces")}
                    | {"launches": launches[key]}
                    | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
