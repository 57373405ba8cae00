"""Fundamental-frequency estimation, batched on the tensor's device
(counterpart of `tinyvc_tpu/dsp/f0.py`).

The default is YIN (de Cheveigné & Kawahara 2002) on a whole batch at once:
the difference function from an FFT autocorrelation, the cumulative-mean
normalisation, the absolute threshold, the descent to the local minimum and
a parabolic refinement. The reference's other labellers keep their names:
``'dio'`` and ``'harvest'`` run pyworld on the host, ``'fcpe'`` torchfcpe,
each when installed, and raise the JAX package's ``ImportError`` otherwise.

The voicing decision compares the normalised difference with 0.15; its
cumulative sums run in fp32, whose order of additions differs between
frameworks and FFT libraries, so a frame near the threshold can change its
decision between devices (`tests/test_torch_f0.py` bounds the share).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .interp import linear_interp_last


def _frame_centered(x: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """``[B, L]`` -> ``[B, L // hop, window]`` frames centred at ``(i +
    0.5) * hop`` in the reflect-padded signal (zero-padded past its end)."""
    n_frames = x.shape[1] // hop
    pad = window // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, hop // 2:]
    need = (n_frames - 1) * hop + window
    if xp.shape[1] < need:
        xp = F.pad(xp, (0, need - xp.shape[1]))
    return xp.unfold(-1, window, hop)[:, :n_frames]


def yin(wf: torch.Tensor, sample_rate: int = 24000, hop: int = 480, window: int = 2048,
        fmin: float = 20.0, fmax: float = 1500.0, threshold: float = 0.15) -> torch.Tensor:
    """``wf`` ``[B, L]`` -> f0 ``[B, L // hop]`` in Hz (0 where unvoiced),
    on ``wf``'s device."""
    tau_max = int(sample_rate / fmin)
    tau_min = max(int(sample_rate / fmax), 2)
    if window <= tau_max:
        raise ValueError("window must exceed the largest lag")
    dev = wf.device
    frames = _frame_centered(wf.float(), window, hop)  # [B, F, W]
    B, n_frames, n = frames.shape
    # d(tau) = e(0) + e(tau) - 2 acf(tau) over the first n - tau_max samples,
    # so that every lag sums as many terms
    sub = frames[..., : n - tau_max]
    csum = torch.cumsum(frames * frames, dim=-1)
    e0 = csum[..., n - tau_max - 1]
    total = F.pad(csum, (1, 0))
    taus = torch.arange(tau_max + 1, device=dev)
    e_tau = total[..., taus + (n - tau_max)] - total[..., taus]  # [B, F, tau_max + 1]
    fft_len = 2 * n
    spec = torch.conj(torch.fft.rfft(sub, fft_len)) * torch.fft.rfft(frames, fft_len)
    corr = torch.fft.irfft(spec, fft_len)[..., : tau_max + 1]
    d = e0[..., None] + e_tau - 2.0 * corr

    # cumulative mean normalised difference, lags below tau_min masked off
    cum = torch.cumsum(d[..., 1:], dim=-1)
    lags = torch.arange(1, tau_max + 1, device=dev, dtype=torch.float32)
    cmndf = d[..., 1:] * lags / torch.clamp_min(cum, 1e-9)
    cmndf = torch.cat([torch.ones(B, n_frames, 1, device=dev), cmndf], dim=-1)
    cmndf = torch.where(taus >= tau_min, cmndf, torch.full_like(cmndf, float("inf")))

    # the first lag under the threshold, then down to where the curve stops
    # falling (argmax returns the first maximum, as jnp.argmax does)
    below = cmndf < threshold
    any_below = below.any(dim=-1)
    first_below = torch.argmax(below.to(torch.int8), dim=-1)
    rising = torch.cat([cmndf[..., 1:] >= cmndf[..., :-1],
                        torch.ones(B, n_frames, 1, dtype=torch.bool, device=dev)], dim=-1)
    after = taus >= first_below[..., None]
    local_min = torch.argmax((rising & after).to(torch.int8), dim=-1)
    tau0 = torch.where(any_below, local_min, torch.argmin(cmndf, dim=-1))

    def gather(off):
        idx = torch.clamp(tau0 + off, 0, tau_max)[..., None]
        return torch.gather(cmndf, -1, idx)[..., 0]

    dm1, d0, dp1 = gather(-1), gather(0), gather(1)
    denom = dm1 + dp1 - 2.0 * d0
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (dm1 - dp1) / denom,
                        torch.zeros_like(denom))
    tau = tau0.float() + torch.clamp(delta, -1.0, 1.0)

    tau = torch.clamp_min(tau, 1.0)
    f0 = torch.full_like(tau, float(sample_rate)) / tau  # a true division, not a reciprocal
    voiced = any_below & (f0 >= fmin) & (f0 <= fmax)
    # silence gate: quiet frames are unvoiced
    voiced &= torch.sqrt(torch.mean(frames * frames, dim=-1)) > 1e-4
    return torch.where(voiced, f0, torch.zeros_like(f0))


def estimate_f0(wf: torch.Tensor, sample_rate: int = 24000, segment_size: int = 480,
                algorithm: str = "yin") -> torch.Tensor:
    """``wf`` ``[B, L]`` -> f0 ``[B, L // segment_size]`` on ``wf``'s device."""
    frames = wf.shape[-1] // segment_size
    if algorithm == "yin":
        return linear_interp_last(yin(wf, sample_rate=sample_rate, hop=segment_size), frames)
    if algorithm in ("dio", "harvest"):
        try:
            import pyworld  # noqa: F401
        except ImportError as e:
            raise ImportError(
                f"algorithm={algorithm!r} needs pyworld (not installed); "
                "use algorithm='yin' (batched on the device) instead") from e
        return _estimate_f0_pyworld(wf, sample_rate, segment_size, algorithm)
    if algorithm == "fcpe":
        try:
            from torchfcpe import spawn_bundled_infer_model  # noqa: F401
        except ImportError as e:
            raise ImportError("algorithm='fcpe' needs torchfcpe (not installed); "
                              "use algorithm='yin' instead") from e
        return _estimate_f0_fcpe(wf, sample_rate, segment_size)
    raise ValueError(f"unknown f0 algorithm {algorithm!r}")


def _estimate_f0_pyworld(wf, sample_rate, segment_size, algorithm):
    """WORLD's dio (with stonemask) or harvest, row by row on the host."""
    import pyworld as pw

    out = []
    for sig in wf.detach().cpu().double().numpy():
        if algorithm == "dio":
            f0, t = pw.dio(sig, sample_rate, f0_floor=20, f0_ceil=20000)
            f0 = pw.stonemask(sig, f0, t, sample_rate)
        else:
            f0, _ = pw.harvest(sig, sample_rate, f0_floor=20, f0_ceil=20000)
        out.append(f0.astype(np.float32))
    f0 = torch.from_numpy(np.stack(out)).to(wf.device)
    return linear_interp_last(f0, wf.shape[-1] // segment_size)


_fcpe_model = None


def _estimate_f0_fcpe(wf, sample_rate, segment_size):
    """torchfcpe's bundled model on the CPU."""
    global _fcpe_model
    from torchfcpe import spawn_bundled_infer_model

    if _fcpe_model is None:
        _fcpe_model = spawn_bundled_infer_model(torch.device("cpu"))
    f0 = _fcpe_model.infer(wf.detach().cpu().float().unsqueeze(2), sample_rate).transpose(1, 2)
    return linear_interp_last(f0[:, 0, :].to(wf.device), wf.shape[-1] // segment_size)
