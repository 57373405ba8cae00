"""Helpers shared by the `test_torch_*.py` parity tests: random JAX
parameter trees and the JAX pipeline's stages on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from tinyvc_tpu.dsp import estimate_energy, shift_frequency, spectrogram
from tinyvc_tpu.infer.generator import convert_fn
from tinyvc_tpu.ops import match_features


def random_params(module, *args, **kwargs):
    """A parameter tree of ``module`` with values drawn by ``jax.random``
    (uniform within +-1/sqrt(fan_in) for kernels, N(1, 0.1) for LayerNorm
    gains, N(0, 0.1) elsewhere: GRN's gamma and beta too, which flax
    initialises to zero and which would hide the GRN path), as numpy.
    Shapes come from ``jax.eval_shape``, so nothing is compiled."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    values = []
    for i, (path, leaf) in enumerate(leaves):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "kernel":
            bound = 1.0 / math.sqrt(int(np.prod(leaf.shape[:-1])))
            v = jax.random.uniform(key, leaf.shape, minval=-bound, maxval=bound)
        else:
            v = 0.1 * jax.random.normal(key, leaf.shape)
            if names[-1] == "gamma" and names[-2] == "norm":
                v = v + 1.0
        values.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, values)


def numpy_params(module, *args, seed: int = 7, **kwargs):
    """:func:`random_params`'s distributions drawn by numpy from ``seed``:
    the same shapes at a fraction of the time (one ``jax.random`` draw a leaf
    compiles for each new shape)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    rng = np.random.default_rng(seed)
    values = []
    for path, leaf in leaves:
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "kernel":
            bound = 1.0 / math.sqrt(int(np.prod(leaf.shape[:-1])))
            v = rng.uniform(-bound, bound, leaf.shape)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
            if names[-1] == "gamma" and names[-2] == "norm":
                v = v + 1.0
        values.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, values)


def jax_stages(encoder, decoder, enc_p, dec_p, wave, target, pitch_shift, angle, cfg):
    """Run `tinyvc_tpu.infer.generator.convert_fn` (jitted) on ``wave`` with
    the explicit noise ``angle``, and the same stages one by one; returns
    numpy arrays keyed as the port's ``convert_fn(stages=...)``, plus
    ``wave``. On the CPU, ``Decoder.dsp`` takes its XLA branches."""
    out = jax.jit(lambda ep, dp, w, t, a: convert_fn(
        encoder, decoder, ep, dp, w, t, jnp.float32(pitch_shift), jax.random.PRNGKey(0), cfg,
        noise_angle=a))(enc_p, dec_p, wave, target, angle)

    @jax.jit
    def stages(ep, dp, w, t, a):
        spec = spectrogram(w, cfg.audio.n_fft, cfg.audio.hop_size)
        content, f0 = encoder.apply(ep, spec, method=encoder.infer)
        tb = jnp.broadcast_to(t[None], (w.shape[0],) + t.shape)
        r = cfg.retrieval
        matched = match_features(content, tb, k=r.k, alpha=r.alpha, metric=r.metric)
        f0 = shift_frequency(f0, pitch_shift)
        energy = estimate_energy(w, cfg.audio.energy_frame_size)
        amps, kern = decoder.apply(dp, matched, f0, energy,
                                   method=lambda m, c, f, e: m.source_net(c, f, e))
        source = decoder.apply(
            dp, f0, amps, kern, jax.random.PRNGKey(0), a,
            method=lambda m, f, am, k, key, na: m.dsp(f, am, k, key, noise_angle=na,
                                                      channels_first=True))
        return dict(spec=spec, content=content, f0=f0, matched=matched, energy=energy,
                    source=source, amps=amps)

    res = {k: np.asarray(v) for k, v in stages(enc_p, dec_p, wave, target, angle).items()}
    res["wave"] = np.asarray(out)
    return res
