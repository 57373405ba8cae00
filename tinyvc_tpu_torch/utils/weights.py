"""Carrying JAX parameter trees over to the port's modules.

The params-only ``.npz`` exports of `tinyvc_tpu/utils/model_store.py`
(read by :func:`load_npz`; `utils/model_store.py` also reads ``.pt``
checkpoints and kNN indexes). The port's modules use the JAX tree's
names, so a flax path ``params/filter_net/up_0/c1/kernel`` becomes the
state-dict key ``filter_net.up_0.c1.weight``. Only layouts change, the
inverse of the transposes in `tinyvc_tpu/utils/torch_compat.py`:

- Dense kernel ``[in, out]``           -> weight ``[out, in]``
- depthwise conv kernel ``[K, 1, C]``  -> weight ``[C, 1, K]``
- full conv kernel ``[K, in, out]``    -> weight ``[out, in, K]``
- ``bias``, ``gamma``, ``beta``        -> unchanged
- a discriminator conv's ``v`` (HWIO), ``g`` -> unchanged (the port keeps
  flax's layout, `models/discriminator.py`)

The fused U-Net (`ops/fused_filternet.py`) takes the FilterNet's weights in
the packed layouts of `tinyvc_tpu/ops/pallas/filter_stage.py`;
:func:`pack_filter_net` builds them from the port's own modules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import AudioConfig, DecoderConfig, DiscriminatorConfig, EncoderConfig
from ..models.decoder import Decoder, Downsample, FilterNet, Upsample
from ..models.discriminator import Discriminator
from ..models.layers import Conv1d
from ..models.encoder import Encoder


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """A nested tree from flat '/'-joined key paths."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_npz(path: str) -> Dict[str, Any]:
    """Rebuild the nested parameter tree from the flat ``params/...`` keys of
    a params-only ``.npz`` (as `model_store.py::_load_params_npz` does)."""
    with np.load(path) as data:
        return nest({key: np.asarray(data[key]) for key in data.files})


def state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree (with or without its ``params`` root)
    into a state dict of the port's layouts."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def rec(prefix: str, node: Mapping[str, Any]) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                rec(f"{prefix}{name}.", value)
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                name = "weight"
            out[prefix + name] = from_jax_layout(arr, name)

    rec("", tree)
    return out


def encoder_from_jax(tree: Mapping[str, Any], cfg: EncoderConfig = EncoderConfig()) -> Encoder:
    """The port's :class:`Encoder` holding the weights of a JAX encoder tree
    (on the CPU, in eval mode)."""
    model = Encoder(cfg)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model.eval()


def decoder_from_jax(tree: Mapping[str, Any], cfg: DecoderConfig = DecoderConfig(),
                     audio: AudioConfig = AudioConfig()) -> Decoder:
    """The port's :class:`Decoder` holding the weights of a JAX decoder tree
    (on the CPU, in eval mode)."""
    model = Decoder(cfg, audio)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model.eval()


def discriminator_from_jax(tree: Mapping[str, Any],
                           cfg: DiscriminatorConfig = DiscriminatorConfig()) -> Discriminator:
    """The port's :class:`Discriminator` holding a JAX discriminator tree
    (``mpd_{p}/conv_{i}|post/{v,g,bias}``, ``mrd_{r}/...``), on the CPU in
    train mode."""
    model = Discriminator(cfg)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model.train()


# ---------------------------------------------------------------------------
# packed weights of the fused U-Net
# ---------------------------------------------------------------------------


def conv_weights_t(conv: Conv1d) -> Tuple[torch.Tensor, torch.Tensor]:
    """A conv's weight ``[Co, Cin, K]`` -> ``[Co, K*Cin]`` tap-major and its
    bias -> ``[Co, 1]`` (`filter_stage.py::_conv_weights_t`)."""
    w = conv.weight
    return (w.permute(0, 2, 1).reshape(w.shape[0], -1).contiguous(),
            conv.bias[:, None].clone())


def upsample_params_to_tuple(up: Upsample) -> Tuple[torch.Tensor, ...]:
    """(wconv ``[4, C, 3C]``, bconv ``[4, C, 1]``, wfilm ``[4C, C]``, bfilm
    ``[4C, 1]``, w5 ``[Co, C]``, b5 ``[Co, 1]``) of an Upsample
    (`filter_stage.py::upsample_params_to_tuple`)."""
    convs = [conv_weights_t(getattr(up, n)) for n in ("c1", "c2", "c3", "c4")]
    films = [up.film1.to_scale, up.film1.to_shift, up.film2.to_scale, up.film2.to_shift]
    return (
        torch.stack([w for w, _ in convs]).contiguous(),
        torch.stack([b for _, b in convs]).contiguous(),
        torch.cat([f.weight for f in films]).contiguous(),
        torch.cat([f.bias for f in films])[:, None].contiguous(),
        up.c5.weight.clone(),
        up.c5.bias[:, None].clone(),
    )


def downsample_params_to_tuple(down: Downsample) -> Tuple[torch.Tensor, ...]:
    """(wres ``[Co, Cin]``, bres, w1, b1, w2, b2, w3, b3) of a Downsample
    (`filter_stage.py::downsample_params_to_tuple`)."""
    out = [down.down_res.weight.clone(), down.down_res.bias[:, None].clone()]
    for name in ("c1", "c2", "c3"):
        out.extend(conv_weights_t(getattr(down, name)))
    return tuple(out)


def fold_output_conv(w5: torch.Tensor, b5: torch.Tensor, output_layer: Conv1d):
    """Fold the k-tap output conv into the last up stage's 1x1
    (`fused_filternet.py:286-296`): ``w5c = w_out @ w5`` ``[k, C]``,
    ``b5c = w_out @ b5`` ``[k, 1]`` and ``bout`` ``[1, 1]``."""
    w_out = output_layer.weight[0].T  # [k, Co]
    return ((w_out @ w5).contiguous(), (w_out @ b5).contiguous(),
            output_layer.bias.reshape(1, 1).clone())


@dataclasses.dataclass(frozen=True)
class FusedFilterWeights:
    """A FilterNet's weights in the fused U-Net's layouts, on its device."""

    stem: Tuple[torch.Tensor, torch.Tensor]  # [Cs, 3*pack_width], [Cs, 1]
    down: Tuple[Tuple[torch.Tensor, ...], ...]  # per Downsample
    up: Tuple[Tuple[torch.Tensor, ...], ...]  # per Upsample; the last one folded


def pack_filter_net(net: FilterNet, pack_width: int, grad: bool = False) -> FusedFilterWeights:
    """Pack ``net``'s weights for `ops/fused_filternet.py`. The stem's input
    columns are zero-padded from its true channel count to ``pack_width``,
    the zero rows `models/decoder.py::Decoder.dsp` appends (as
    `filter_stage.py::fused_conv3_t` pads them). With ``grad`` the packing
    is differentiable, so that autograd carries the packed weights'
    gradients back to the parameters (the training step's fused U-Net)."""
    with torch.set_grad_enabled(grad):
        w0, b0 = conv_weights_t(net.down_0)
        co, cin = w0.shape[0], net.down_0.weight.shape[1]
        if pack_width < cin:
            raise ValueError(f"pack_width {pack_width} < the stem's {cin} channels")
        w0 = torch.nn.functional.pad(w0.reshape(co, 3, cin), (0, pack_width - cin))
        down = tuple(downsample_params_to_tuple(getattr(net, f"down_{i + 1}"))
                     for i in range(net.num_down))
        up = [upsample_params_to_tuple(getattr(net, f"up_{i}")) for i in range(net.num_up)]
        wconv, bconv, wfilm, bfilm, w5, b5 = up[-1]
        up[-1] = (wconv, bconv, wfilm, bfilm, *fold_output_conv(w5, b5, net.output_layer))
        return FusedFilterWeights((w0.reshape(co, 3 * pack_width).contiguous(), b0),
                                  down, tuple(up))


# ---------------------------------------------------------------------------
# the train state
# ---------------------------------------------------------------------------


def jax_name(name: str) -> str:
    """A state-dict key -> its flax path under ``params``
    (``filter_net.up_0.c1.weight`` -> ``params/filter_net/up_0/c1/kernel``)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(["params"] + parts)


def from_jax_layout(a: np.ndarray, name: str) -> torch.Tensor:
    """One flax array in the layout of the port's tensor ``name``: a kernel
    transposed to a weight, anything else as it is."""
    if name.endswith("weight"):
        a = a.T if a.ndim == 2 else np.transpose(a, (2, 1, 0))
    return torch.tensor(np.ascontiguousarray(a))


def to_jax_layout(t: torch.Tensor, name: str) -> np.ndarray:
    """The inverse of :func:`state_dict_from_jax`'s transposes for one
    tensor: a weight back to flax's kernel layout."""
    a = t.detach().float().cpu().numpy()
    if name.endswith(".weight"):
        a = a.T if a.ndim == 2 else np.transpose(a, (2, 1, 0))
    return np.ascontiguousarray(a)


def _adam_from_jax(adam: Any, device, notfinite_count: int = 0):
    """An ``OptState`` from optax's ``ScaleByAdamState``: AdamW's moments
    and Adam's count."""
    from ..train.decoder_train import OptState

    mu = state_dict_from_jax({"params": adam.mu["params"]})
    nu = state_dict_from_jax({"params": adam.nu["params"]})
    return OptState({k: v.to(device) for k, v in mu.items()},
                    {k: v.to(device) for k, v in nu.items()},
                    int(np.asarray(adam.count)), notfinite_count)


def _opt_from_jax(opt: Any, device):
    """An ``OptState`` from JAX's ``skip_if_nonfinite(chain(clip, adamw))``
    state: AdamW's moments, Adam's count and the skip count."""
    return _adam_from_jax(opt.inner[1][0], device, int(np.asarray(opt.notfinite_count)))


def encoder_train_state_from_jax(state: Any, cfg: EncoderConfig = EncoderConfig(),
                                 device="cpu"):
    """The port's encoder train state (`train/encoder_train.py::
    EncoderTrainState`) from JAX's ``EncoderTrainState`` (numpy leaves):
    the parameters, the moments and count of optax's ``chain(
    clip_by_global_norm, adamw)`` state, and the step."""
    from ..train.encoder_train import EncoderTrainState

    enc = encoder_from_jax(state.params, cfg).train().to(device)
    return EncoderTrainState(enc, _adam_from_jax(state.opt_state[1][0], device),
                             int(np.asarray(state.step)))


def train_state_from_jax(state: Any, cfg: DecoderConfig = DecoderConfig(),
                         audio: AudioConfig = AudioConfig(), device="cpu",
                         disc_cfg: Optional[DiscriminatorConfig] = None):
    """The port's train state (`train/decoder_train.py::TrainState`) from a
    JAX ``GanTrainState`` (or its ``gen_params`` tree): the generator's
    parameters, its moments, Adam's count and the skip count; with
    ``disc_cfg`` and a state whose ``disc_params`` are not empty, the
    discriminator's too. A fresh JAX state has zero moments, as the port's
    ``init_state``."""
    from ..train.decoder_train import TrainState

    params = getattr(state, "gen_params", state)
    dec = decoder_from_jax(params, cfg, audio).train().to(device)
    disc_params = getattr(state, "disc_params", None)
    disc = None
    if disc_cfg is not None and disc_params:
        disc = discriminator_from_jax(disc_params, disc_cfg).to(device)
    ts = TrainState.fresh(dec, disc)
    if getattr(state, "gen_opt", None) is not None:
        ts.gen_opt = _opt_from_jax(state.gen_opt, device)
        ts.step = int(np.asarray(state.step))
        if disc is not None:
            ts.disc_opt = _opt_from_jax(state.disc_opt, device)
    return ts
