"""Plain PyTorch reference of TinyVC's whole-utterance kNN conversion.

Written from the model's equations (uthree/tinyvc ``module/tinyvc``: a
ConvNeXt-v2 content encoder and pitch classifier on the magnitude
spectrogram, kNN matching against a target speaker's features, a SourceNet
predicting harmonic amplitudes and a noise filter, a harmonic-plus-noise DSP
source, and a U-Net filter at the waveform rate) and from the conversion
semantics of the system under test: 64-frame bucket padding, edge-replicated
U-Net chains, the output conv fed by the chain's own edge columns. It uses
``torch.nn.functional`` and nothing of the program: no kernel, no weight
packing, no batching trick. Weights come straight from the shipped
params-only ``.npz`` (flax layouts: a dense kernel ``[in, out]``, a conv
kernel ``[K, in, out]``, a depthwise kernel ``[K, 1, C]``).

Everything runs in ``dtype`` (float64 by default: the truth that the
program's fp32 and bf16 arithmetic is held to). :class:`Precision` rounds the
operands of products for the control: the reference computed in the
precision just below the one the configuration states.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from . import prng

Weights = Dict[str, torch.Tensor]


def load_weights(path: str, device, dtype=torch.float64, prefix: str = "params/") -> Weights:
    """The ``.npz``'s arrays by their flax paths without ``params/``."""
    with np.load(path) as data:
        return {k[len(prefix):]: torch.from_numpy(np.asarray(data[k])).to(device, dtype)
                for k in data.files}


# ---------------------------------------------------------------------------
# precision of the control
# ---------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (fp32 with 10 mantissa bits, round half away
    from zero), returned in ``x``'s dtype."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return bits.view(torch.float32).to(x.dtype)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` quantised to fp8 e4m3 under one per-tensor scale that maps its
    largest magnitude to just under 448, returned in ``x``'s dtype."""
    amax = float(x.abs().max())
    if amax == 0.0:
        return x
    scale = 0.999 * 448.0 / amax
    return (x * scale).float().to(torch.float8_e4m3fn).to(x.dtype) / scale


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Precision:
    """How the operands of the reference's products are rounded: ``fp32``
    for the products the configuration computes in fp32 (and the inputs of
    its fp32 transforms and oscillators), ``low`` for those it computes in
    its decoder's lower dtype (and the dictionary rows that a matched frame
    averages). The reference proper leaves both exact."""

    def __init__(self, fp32: Callable = _identity, low: Callable = _identity):
        self.fp32, self.low = fp32, low

    @classmethod
    def control(cls, decoder_dtype: str) -> "Precision":
        """TF32 for fp32 products; fp8 e4m3 for bf16 ones."""
        return cls(tf32_round, fp8_round if decoder_dtype == "bfloat16" else tf32_round)


EXACT = Precision()


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------


def bucket_pad(wave: np.ndarray, hop: int, bucket_frames: int) -> np.ndarray:
    """``[B, L]`` zero-padded to the next multiple of ``hop * bucket_frames``
    samples: the padding is part of the result (GRN spans it)."""
    step = hop * bucket_frames
    target = -(-wave.shape[-1] // step) * step
    return np.pad(wave, ((0, 0), (0, target - wave.shape[-1])))


def hann(n: int, device, dtype) -> torch.Tensor:
    k = torch.arange(n, device=device, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).to(dtype)


def spectrogram(wave: torch.Tensor, n_fft: int, hop: int, prec: Precision = EXACT):
    """``|STFT|`` ``[B, L // hop, n_fft // 2 + 1]``: centred frames with
    reflect padding, periodic Hann window, frame 0 dropped."""
    L = wave.shape[-1]
    x = F.pad(wave[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)[:, 1:1 + L // hop]
    frames = prec.fp32(frames * hann(n_fft, wave.device, wave.dtype))
    return torch.fft.rfft(frames, dim=-1).abs()


def energy(wave: torch.Tensor, frame: int) -> torch.Tensor:
    """Max of ``|x|`` over windows of ``2 * frame`` every ``frame`` samples,
    linearly interpolated back to the sample rate."""
    pooled = F.max_pool1d(wave.abs()[:, None], 2 * frame, frame, frame // 2)
    return F.interpolate(pooled, size=wave.shape[-1], mode="linear", align_corners=False)[:, 0]


# ---------------------------------------------------------------------------
# ConvNeXt stacks (encoder, SourceNet)
# ---------------------------------------------------------------------------


def _dense(x, w: Weights, name: str, rnd: Callable):
    return torch.matmul(rnd(x), rnd(w[name + "/kernel"])) + w[name + "/bias"]


def _layer_norm(x, w: Weights, name: str, eps: float = 1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w[name + "/gamma"] + w[name + "/beta"]


def _convnext(x, w: Weights, name: str, dilation: int, rnd: Callable):
    """ConvNeXt-v2 block on ``[B, T, C]``: depthwise k=7 conv (replicate
    padded), LayerNorm, 1x1 to 2C, exact GELU, GRN over time, 1x1 back,
    residual."""
    k = w[name + "/dw/kernel"]  # [K, 1, C]
    pad = (k.shape[0] - 1) * dilation // 2
    xt = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    y = F.conv1d(rnd(xt), rnd(k.permute(2, 1, 0)), w[name + "/dw/bias"], dilation=dilation,
                 groups=x.shape[-1]).transpose(1, 2)
    y = F.gelu(_dense(_layer_norm(y, w, name + "/norm"), w, name + "/pw1", rnd))
    gx = torch.sqrt((y * y).sum(1, keepdim=True))
    y = w[name + "/grn/gamma"] * (y * gx / (gx.mean(-1, keepdim=True) + 1e-6)) \
        + w[name + "/grn/beta"] + y
    return _dense(y, w, name + "/pw2", rnd) + x


def _stack(x, w: Weights, name: str, dilations, rnd: Callable):
    x = _layer_norm(_dense(x, w, name + "/input_layer", rnd), w, name + "/norm")
    for i, d in enumerate(dilations):
        x = _convnext(x, w, f"{name}/layer_{i}", d, rnd)
    return _dense(x, w, name + "/output_layer", rnd)


def encode(spec, w: Weights, enc: Mapping, prec: Precision = EXACT):
    """Spectrogram -> (content ``[B, T, 768]``, pitch logits ``[B, T, 512]``),
    both stacks in the encoder's fp32."""
    content = _stack(spec, w, "ssl_feature_estimator/stack", enc["ssl_dilations"], prec.fp32)
    logits = _stack(spec, w, "pitch_estimator/stack", (1,) * enc["pitch_num_layers"], prec.fp32)
    return content, logits


def class_freq(ids, enc: Mapping):
    f = enc["min_frequency"] * torch.pow(2.0, ids.to(torch.float64) / enc["classes_per_octave"])
    return torch.where(f <= enc["min_frequency"], torch.zeros_like(f), f)


def f0_raw(values, ids, enc: Mapping):
    """The softmax-weighted mean of a set of classes' frequencies."""
    return (torch.softmax(values, -1) * class_freq(ids, enc)).sum(-1)


def f0_of(values, ids, enc: Mapping):
    """f0 from a set of classes and their logits: :func:`f0_raw`, 0 at or
    below ``min_frequency``."""
    f0 = f0_raw(values, ids, enc)
    return torch.where(f0 <= enc["min_frequency"], torch.zeros_like(f0), f0)


def decode_f0(logits, enc: Mapping):
    vals, ids = torch.topk(logits, enc["pitch_topk"], dim=-1)
    return f0_of(vals, ids, enc)


def shift_pitch(f0, semitones: float):
    midi = torch.log2((f0 / 440.0).clamp_min(0.0) + 1e-6) * 12.0 + 69.0
    return 440.0 * torch.pow(2.0, (midi + semitones - 69.0) / 12.0)


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------


def cos_similarities(content, dictionary, prec: Precision = EXACT):
    """``[B, T, N]`` cosine similarities (norms plus 1e-6)."""
    a = content / (content.norm(dim=-1, keepdim=True) + 1e-6)
    b = dictionary / (dictionary.norm(dim=-1, keepdim=True) + 1e-6)
    return torch.matmul(prec.fp32(a), prec.fp32(b).T)


def match(content, dictionary, k: int, prec: Precision = EXACT):
    """Each frame -> the mean of its ``k`` most similar dictionary rows (the
    rows in the decoder's dtype: kernel H averages bf16-rounded rows)."""
    _, idx = torch.topk(cos_similarities(content, dictionary, prec), k, dim=-1)
    return prec.low(dictionary[idx]).mean(-2)


# ---------------------------------------------------------------------------
# SourceNet and the DSP source
# ---------------------------------------------------------------------------


def _log_f0(f0):
    return torch.log(f0.clamp_min(0.0) + 1e-6)[..., None]


def source_net(matched, f0, energy_wave, w: Weights, hop: int, prec: Precision = EXACT):
    """-> (harmonic amplitudes ``[B, F, H+1]``, noise filter ``[B, F, bins]``):
    the trunk in the decoder's dtype, the two heads in fp32."""
    B, L = energy_wave.shape
    e = energy_wave.reshape(B, L // hop, hop).amax(-1)[..., None]
    x = (_dense(matched, w, "source_net/content_in", prec.low)
         + _dense(e, w, "source_net/energy_in", prec.low)
         + _dense(_log_f0(f0), w, "source_net/f0_in", prec.low))
    i = 0
    while f"source_net/layer_{i}/dw/kernel" in w:
        x = _convnext(x, w, f"source_net/layer_{i}", 1, prec.low)
        i += 1
    amps = F.elu(_dense(x, w, "source_net/to_amps", prec.fp32)) + 1.0
    kernel = F.elu(_dense(x, w, "source_net/to_kernel", prec.fp32)) + 1.0
    return amps, kernel


def _to_rate(x, length: int):
    """Frame-rate ``[B, F]`` or ``[B, C, F]`` -> ``length`` samples, linear,
    half-sample centred, edges held."""
    squeeze = x.dim() == 2
    y = F.interpolate(x[:, None] if squeeze else x, size=length, mode="linear",
                      align_corners=False)
    return y[:, 0] if squeeze else y


def harmonics(f0, amps, hop: int, sr: int, fmin: float, prec: Precision = EXACT):
    """``[B, H+1, L]``: ``sin(2 pi ((k * phase) mod 1))`` times the
    interpolated amplitude and voiced flag, the phase the running sum of the
    interpolated ``f0 / sr``."""
    f0, amps = prec.fp32(f0), prec.fp32(amps)
    L = f0.shape[1] * hop
    phase = torch.cumsum(_to_rate(f0, L) / sr, dim=-1)
    uv = _to_rate((f0 > fmin).to(f0.dtype), L)
    k = torch.arange(1, amps.shape[-1] + 1, device=f0.device, dtype=f0.dtype)[:, None]
    theta = 2.0 * math.pi * torch.remainder(phase[:, None] * k, 1.0)
    return torch.sin(theta) * uv[:, None] * _to_rate(amps.transpose(1, 2), L)


def noise(kernel, noise_seed: int, hop: int, n_fft: int, prec: Precision = EXACT,
          row0: int = 0):
    """``[B, F * hop]``: the filter magnitudes with the hashed phases of
    batch rows ``row0 ..``, one zero frame in front, inverse STFT (Hann,
    centred)."""
    B, nf, bins = kernel.shape
    angle = prng.noise_angles(B, nf, bins, noise_seed, kernel.device, row0).to(kernel.dtype)
    spec = torch.polar(prec.fp32(kernel), angle)
    spec = F.pad(spec, (0, 0, 1, 0)).transpose(1, 2)
    return torch.istft(spec, n_fft, hop, window=hann(n_fft, kernel.device, kernel.dtype),
                       center=True, length=nf * hop)


# ---------------------------------------------------------------------------
# the U-Net
# ---------------------------------------------------------------------------

UP_DILATIONS = (1, 3, 9, 27)
DOWN_DILATIONS = (1, 2, 4)


def _conv(x, w: Weights, name: str, dilation: int, rnd: Callable):
    """Unpadded conv of ``[B, C, T]`` with the flax kernel ``[K, in, out]``."""
    return F.conv1d(rnd(x), rnd(w[name + "/kernel"].permute(2, 1, 0)), w[name + "/bias"],
                    dilation=dilation)


def _pointwise(x, w: Weights, name: str, rnd: Callable):
    """1x1 of channels-first ``[B, C, T]`` with a dense kernel ``[in, out]``."""
    return torch.matmul(rnd(w[name + "/kernel"]).T, rnd(x)) + w[name + "/bias"][:, None]


def _edge(x, r: int):
    return F.pad(x, (r, r), mode="replicate")


def down_chain(z, w: Weights, name: str, rnd: Callable):
    """One Downsample body after its decimation: the input edge-padded by the
    chain's reach (7), three dilated k=3 convs after leaky ReLUs, unpadded,
    plus the 1x1 residual."""
    x = F.leaky_relu(_edge(z, sum(DOWN_DILATIONS)), 0.1)
    for i, d in enumerate(DOWN_DILATIONS):
        x = _conv(x, w, f"{name}/c{i + 1}", d, rnd)
        if i < 2:
            x = F.leaky_relu(x, 0.1)
    return x + _pointwise(z, w, name + "/down_res", rnd)


def up_chain(xu, cond, w: Weights, name: str, rnd: Callable, extra: int = 0):
    """One Upsample body after its interpolation: input and condition
    edge-padded by the reach (40, plus ``extra`` columns a side for a conv
    that follows), two FiLM-modulated residual pairs of dilated convs,
    unpadded, then the 1x1 out."""
    R = sum(UP_DILATIONS) + extra
    x, c = _edge(xu, R), _edge(cond, R)
    film = [_pointwise(c, w, f"{name}/film{j}/to_{p}", rnd)
            for j in (1, 2) for p in ("scale", "shift")]
    h = x
    for pair, (d1, d2) in enumerate(((1, 3), (9, 27))):
        res = h
        h = _conv(F.leaky_relu(h, 0.1), w, f"{name}/c{2 * pair + 1}", d1, rnd)
        h = _conv(F.leaky_relu(h, 0.1), w, f"{name}/c{2 * pair + 2}", d2, rnd)
        cut = (res.shape[-1] - h.shape[-1]) // 2
        off = (film[0].shape[-1] - h.shape[-1]) // 2
        n = h.shape[-1]
        h = h * film[2 * pair][..., off:off + n] + film[2 * pair + 1][..., off:off + n] \
            + res[..., cut:cut + n]
    return _pointwise(h, w, name + "/c5", rnd)


def _decimate(x, f: int):
    T = x.shape[-1] // f
    blocks = x[..., :T * f].reshape(*x.shape[:-1], T, f)
    if f % 2:
        return blocks[..., (f - 1) // 2]
    return 0.5 * (blocks[..., f // 2 - 1] + blocks[..., f // 2])


def unet(matched, f0, energy_wave, source, w: Weights, dec: Mapping, prec: Precision = EXACT):
    """The waveform ``[B, L]`` from the matched content, f0, the energy and
    the DSP source ``[B, H+2, L]``: a k=3 stem over ``[source; energy]``,
    decimations each followed by a down chain, then interpolations each
    followed by an up chain conditioned on the skip of its rate, the k=7
    output conv (fp32) taking the last chain's own columns at the edges."""
    low, name = prec.low, "filter_net"
    x = (_dense(matched, w, name + "/content_in", low)
         + _dense(_log_f0(f0), w, name + "/f0_in", low)).transpose(1, 2)
    src = _conv(_edge(torch.cat([source, energy_wave[:, None]], 1), 1), w, name + "/down_0", 1,
                low)
    skips = [src]
    for i, f in enumerate(reversed(dec["filter_factors"][1:])):
        src = down_chain(_decimate(src, f), w, f"{name}/down_{i + 1}", low)
        skips.append(src)
    out_k = w[name + "/output_layer/kernel"].shape[0]
    factors = dec["filter_factors"]
    for i, f in enumerate(factors):
        xu = F.interpolate(x, scale_factor=f, mode="linear", align_corners=False)
        last = i == len(factors) - 1
        x = up_chain(xu, skips[-1 - i], w, f"{name}/up_{i}", low,
                     extra=(out_k - 1) // 2 if last else 0)
    return _conv(x, w, name + "/output_layer", 1, prec.fp32)[:, 0]


# ---------------------------------------------------------------------------
# the whole conversion, for the control
# ---------------------------------------------------------------------------


class Reference:
    """The configuration's weights and sizes on one device."""

    def __init__(self, cfg: Mapping, root: str, device, dtype=torch.float64):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.enc_w = load_weights(f"{root}/{cfg['weights']['encoder']}", device, dtype)
        self.dec_w = load_weights(f"{root}/{cfg['weights']['decoder']}", device, dtype)
        a = cfg["audio"]
        self.hop, self.n_fft, self.sr = a["hop_size"], a["n_fft"], a["sample_rate"]

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, self.dtype)

    def front(self, wave_padded: np.ndarray, prec: Precision = EXACT):
        """(energy, content, logits) of a bucket-padded ``[B, L]``."""
        x = self.tensor(wave_padded)
        spec = spectrogram(x, self.n_fft, self.hop, prec)
        content, logits = encode(spec, self.enc_w, self.cfg["encoder"], prec)
        return energy(x, self.cfg["audio"]["energy_frame_size"]), content, logits

    def dictionary(self, target: np.ndarray, prec: Precision = EXACT) -> torch.Tensor:
        """``[N, C]`` from target utterances ``[n, L]``: each encoded whole at
        its bucket, the frames past its end dropped."""
        frames = target.shape[-1] // self.hop
        padded = bucket_pad(target, self.hop, self.cfg["bucket_frames"])
        rows = [self.front(padded[i:i + 1], prec)[1][0, :frames] for i in range(len(padded))]
        return torch.cat(rows)

    def dsp(self, f0, amps, kernel, noise_seed: int, prec: Precision = EXACT, row0: int = 0):
        """The source ``[B, H+2, L]`` of batch rows ``row0 ..``."""
        h = harmonics(f0, amps, self.hop, self.sr, self.cfg["encoder"]["min_frequency"], prec)
        n = noise(kernel, noise_seed, self.hop, self.n_fft, prec, row0)
        return torch.cat([h, n[:, None]], 1)

    def convert(self, wave_padded: np.ndarray, dictionary, pitch_shift: float, noise_seed: int,
                prec: Precision = EXACT, row0: int = 0) -> Dict[str, torch.Tensor]:
        """The stages of batch rows ``row0 ..`` of one request, computed by
        the reference alone."""
        e, content, logits = self.front(wave_padded, prec)
        f0 = shift_pitch(decode_f0(logits, self.cfg["encoder"]), pitch_shift)
        matched = match(content, dictionary, self.cfg["retrieval"]["k"], prec)
        amps, kernel = source_net(matched, f0, e, self.dec_w, self.hop, prec)
        source = self.dsp(f0, amps, kernel, noise_seed, prec, row0)
        out = unet(matched, f0, e, source, self.dec_w, self.cfg["decoder"], prec)
        return dict(content=content, f0=f0, matched=matched, amps=amps, noise_kernel=kernel,
                    source=source, out=out)
