#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tinyvc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed; any failure exits non-zero:

1. env: Python, torch and CUDA versions, ``nvcc --version``, and the card's
   name and power limit from ``nvidia-smi``.
2. build: the CUDA kernels of `tinyvc_tpu_torch/kernels/csrc/` with one
   ``nvcc`` call.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the conversion path's shapes (B=1, F=320 frames, L=153,600 samples) and at
   a ragged shape (B=3 or 2, F=37), with kernel, plain and library times
   (CUDA events, median of 25 after warm-up) and the bound from bytes and
   FLOPs. The fused U-Net's kernels (C at its five up stages, D, E, F) run
   every stage's shapes with the two-speaker decoder's weights; their row
   sums the stages of one request.
4. convert: ``VoiceConverter`` on CUDA with the two-speaker weights and kNN
   index, answering three requests (the 6 s demo utterance cold, warm, then
   a batch of 4) with the default config, so the fused U-Net; every
   kernel's launch counter must rise; the output must be finite, as long as
   the input, within ``WAVE_ATOL`` of the same request on the CPU (fused
   too, ``use_fused_filter="on"``), and within ``MEL_L1_BOUND`` of the
   demo's converted rendition. The card's distance to its own
   layer-by-layer U-Net (``"off"``) is printed, not gated: the two differ
   near the utterance's ends by design.
5. profile: warm request latency at B=1 and B=4 and, from ``torch.profiler``,
   the device time of one request by kernel group and the device's idle share.

The last two lines are one JSON object of per-kernel numbers and the
``{"ok": true, "device": ...}`` result. Needs CUDA and the rest of the repo;
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
#  B: same hashed phases bit for bit; a 961-term fp32 DFT sum against
#     cuFFT's irfft (1e-5, the JAX package's own kernel-vs-istft bound).
#  C, D: the same fp32 products and sums in the same order: bit-exact, the
#     bound allows one rounding at values <= 1.
#  E, F (relative to the plain version's peak): fp32 sums of up to 3*384
#     terms in another order than cuDNN's (TF32 off on both sides), through
#     three (E) or four (F) convs, FiLM products and residual adds; the H100
#     showed at most 7.4e-7 of the peak (1.55e-6 at peak 2.08).
KERNEL_TOL = {"oscillator": 1e-2, "noise": 1e-5, "upsample": 1e-6, "downsample": 1e-6}
CHAIN_RTOL = {"down_chain": 1e-5, "up_chain": 1e-5}
# Whole conversion, card against CPU and port against JAX (the CPU tests hold
# the port to the same bound): kernel A's phase is closer to the float64
# truth than the fp32 plain version (by up to ~7e-3 at amplitude 3), and the
# U-Net carries that into the waveform; 1e-3 is 0.2% of the output's peak
# (~0.5).
WAVE_ATOL = 1e-3
# Log-mel L1 of the port's 6 s output against demo/two_speaker/
# converted_A_to_B.wav. The CPU test measures the port there (0.354 to 0.357
# over noise seeds 0-3); the source itself is 2.46 away.
MEL_L1_BOUND = 0.40

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores


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


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
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

    # B: noise, seed and angle modes
    errs = []
    for B, F_ in ((1, 320), (3, 37)):
        mag = torch.from_numpy(np.abs(rng.standard_normal((B, F_, bins))).astype(np.float32)).to(dev)
        ang = torch.from_numpy(rng.uniform(-np.pi, np.pi, (B, F_, bins)).astype(np.float32)).to(dev)
        for mode, angle in (("seed", None), ("angle", ang)):
            got = oscillate_noise_hashed(mag, 7, hop, n_fft, angle=angle)
            want = oscillate_noise_plain(mag, 7, hop, n_fft, angle=angle)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            report("noise", f"{mode} B={B} F={F_}", err, KERNEL_TOL["noise"])
            errs.append(err)
        if B == 1:
            main_b = (mag, ang)
    mag, ang = main_b
    F_ = mag.shape[1]
    spec = F.pad(torch.polar(mag, ang), (0, 0, 1, 0)).transpose(1, 2).contiguous()
    win = hann_window(n_fft, dev)

    def lib_istft():
        return torch.istft(spec, n_fft, hop, window=win, center=True)

    lib_err = float((lib_istft() - oscillate_noise_hashed(mag, 7, hop, n_fft, angle=ang)).abs().max())
    print(f"  noise: torch.istft vs kernel (angle mode) max_abs_err {lib_err:.3e}")
    results["noise"] = dict(
        name="noise", route="cuda", source="tinyvc_tpu_torch/kernels/csrc/noise.cu",
        replaces="tinyvc_tpu/ops/pallas/noise.py:175", max_abs_err=max(errs),
        ms=_cuda_ms(lambda: oscillate_noise_hashed(mag, 7, hop, n_fft)),
        plain_ms=_cuda_ms(lambda: oscillate_noise_plain(mag, 7, hop, n_fft)),
        # the work an FFT-based iSTFT needs: per frame a real inverse FFT
        # (2.5 n log2 n, half a complex FFT's 5 n log2 n), the polar product
        # (2 per bin), window and overlap-add (2 per sample) and the envelope
        # divide (1 per output sample); bytes: mag read once, output written once
        bound=_bound(4 * (mag.numel() + F_ * hop),
                     F_ * (2.5 * n_fft * math.log2(n_fft) + 2 * bins + 2 * n_fft + hop)),
        library_ms=_cuda_ms(lib_istft),
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


def phase_unet_kernels(results: dict, rng, dev) -> None:
    """Kernels D, E, F, and C at the U-Net's up stages, each call of one
    fused U-Net request against its plain version, with the two-speaker
    decoder's packed weights and N(0, 0.25) activations: at B=1, F=320 (timed,
    summed into one row per kernel) and at a ragged B=2, F=37."""
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
    acc = {k: dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bounds=[])
           for k in ("upsample", "downsample", "down_chain", "up_chain")}

    def randn(*shape):
        return torch.from_numpy((0.5 * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    def check(name, case, kernel, plain, tol, relative, timed, bound, library=None):
        with exact_fp32():
            got, want = kernel(), plain()
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
              CHAIN_RTOL["down_chain"], True, timed,
              _bound(4 * (x.numel() + B * cs * L), 2.0 * B * L * cs * 3 * (n_src + 1)))
        T = L
        for cin, f, wd in zip(reversed(chans[1:]), reversed(facs[1:]), w.down):
            xin = randn(B * cin, T)
            check("downsample", f"B*C={B * cin} T={T} /{f}",
                  lambda: downsample_linear(xin, f), lambda: downsample_linear_plain(xin, f),
                  KERNEL_TOL["downsample"], False, timed,
                  _bound(4 * (xin.numel() + xin.numel() // f),
                         0.0 if f % 2 else 3.0 * xin.numel() // f),
                  library=decimate_lib(xin, f))
            T //= f
            z = randn(B, cin, T)
            co = wd[0].shape[0]
            check("down_chain", f"B={B} [{cin} -> {co}, {T}]",
                  lambda: fs.downsample_chain(z, *wd), lambda: fs.downsample_chain_plain(z, *wd),
                  CHAIN_RTOL["down_chain"], True, timed,
                  _bound(4 * B * T * (cin + co), 2.0 * B * T * (6 * cin * cin + 4 * cin * co)))
        Tx = F_
        for i, (c, f, wu) in enumerate(zip(chans, facs, w.up)):
            xin = randn(B * c, Tx)
            check("upsample", f"B*C={B * c} T={Tx} x{f}",
                  lambda: upsample_linear(xin, f), lambda: upsample_linear_plain(xin, f),
                  KERNEL_TOL["upsample"], False, timed,
                  _bound(4 * xin.numel() * (1 + f), 5.0 * xin.numel() * f),
                  library=lambda: F.interpolate(xin[:, None], scale_factor=f, mode="linear",
                                                align_corners=False))
            Tx *= f
            xu, cond = randn(B, c, Tx), randn(B, c, Tx)
            fold = i == len(chans) - 1
            co = 1 if fold else wu[4].shape[0]
            kw = dict(fold_k=wu[4].shape[0], bout=wu[6]) if fold else {}
            ww = wu[:6]
            # four k=3 convs and the two FiLMs' [4C, C] product: 32 C^2 per
            # sample; the output 1x1 (or the folded k=7 conv) 2 * Co' * C
            check("up_chain", f"B={B} [{c} -> {co}{' folded' if fold else ''}, {Tx}]",
                  lambda: fs.upsample_chain(xu, cond, *ww, **kw),
                  lambda: fs.upsample_chain_plain(xu, cond, *ww, **kw),
                  CHAIN_RTOL["up_chain"], True, timed,
                  _bound(4 * B * Tx * (2 * c + co),
                         B * Tx * (32.0 * c * c + 2.0 * wu[4].shape[0] * c)))

    up = results["upsample"]
    a = acc["upsample"]
    up.update(max_abs_err=max(up["max_abs_err"], a["err"]), ms=up["ms"] + a["ms"],
              plain_ms=up["plain_ms"] + a["plain"], library_ms=up["library_ms"] + a["lib"],
              bound=_sum_bounds([up["bound"]] + a["bounds"]))
    kernels_dir = "tinyvc_tpu_torch/kernels/csrc"
    for name, source, replaces, lib in (
        ("downsample", "resample.cu", "tinyvc_tpu/ops/pallas/resample.py:198", True),
        ("down_chain", "filter_stage.cu", "tinyvc_tpu/ops/pallas/filter_stage.py:595", False),
        ("up_chain", "filter_stage.cu", "tinyvc_tpu/ops/pallas/filter_stage.py:354", False),
    ):
        a = acc[name]
        results[name] = dict(
            name=name, route="cuda", source=f"{kernels_dir}/{source}", replaces=replaces,
            max_abs_err=a["err"], ms=a["ms"], plain_ms=a["plain"],
            bound=_sum_bounds(a["bounds"]), library_ms=a["lib"] if lib else None,
        )


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
    return launches, (vc, target, wave)


# Kernel-name fragments -> group for the profile; the first match wins.
# cuDNN's convolutions are implicit GEMMs ("fprop_implicit_gemm",
# "implicit_convolve_sgemm"), so they are matched before plain GEMMs.
PROFILE_GROUPS = (
    ("kernel A (oscillator)", ("osc_frame_sums", "osc_synth")),
    ("kernel B (noise)", ("noise_synth",)),
    ("kernel C (upsample)", ("upsample_linear_kernel",)),
    ("kernel D (downsample)", ("downsample_linear_kernel",)),
    ("kernel E (stem, down chains)", ("down_chain_step",)),
    ("kernel F (up chains)", ("up_chain_step",)),
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


def phase_profile(card: str, vc, target, wave, requests: int = 5) -> None:
    """Where a warm request's time goes, at B=1 and B=4: the median host
    latency of ``requests`` requests (each ends in a synchronise), then one
    request under ``torch.profiler`` with its kernel time by group. Idle
    share = 1 - kernel time of the profiled request / median latency; the
    port runs on one stream, so kernels do not overlap."""
    from collections import defaultdict

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    for B in (1, 4):
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
        print(f"  B={B}: warm request median {med * 1e3:.3f} ms over {requests} "
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
            print(f"  B={B}: the profiler recorded no device time; breakdown not measured")
            continue
        print(f"  B={B}: device busy {busy:.3f} ms in {sum(v[1] for v in kernels.values())} "
              f"kernels, idle share {1.0 - busy / (med * 1e3):.3f}")
        groups = defaultdict(float)
        for name, (ms, _) in kernels.items():
            groups[_profile_group(name)] += ms
        for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {group:38s} {ms:9.3f} ms  {ms / busy:6.1%}")
        for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"    top {ms:9.3f} ms  x{n:<4d} {name[:100]}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "tinyvc_tpu_torch")):
        print("chip_smoke.py needs the repository around it (tinyvc_tpu_torch/)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py runs on a GPU", file=sys.stderr)
        return 1

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
    launches, ctx = phase_convert(card)
    _done("convert", t0)
    t0 = _phase("profile")
    phase_profile(card, *ctx)
    _done("profile", t0)
    print(f"== total: {time.perf_counter() - t_all:.2f} s")

    rows = []
    for key in ("oscillator", "noise", "upsample", "downsample", "down_chain", "up_chain"):
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
