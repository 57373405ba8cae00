"""The port's checkpoint loaders (`tinyvc_tpu_torch/utils/model_store.py`,
`utils/torch_compat.py`) against `tinyvc_tpu.utils.torch_compat`: reference
``.pt`` state dicts, written here from the two-speaker ``.npz`` exports by
the inverse of the name mapping, load to the same trees in both packages and
convert as the ``.npz`` files do."""

import os

import numpy as np
import pytest
import torch

from tinyvc_tpu.utils import torch_compat as jcompat
from tinyvc_tpu_torch.infer.generator import VoiceConverter
from tinyvc_tpu_torch.utils import model_store, torch_compat
from tinyvc_tpu_torch.utils.weights import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models", "two_speaker")


# the inverse of the mapping: JAX tree -> reference state dict ------------------

def _dense(sd, prefix, node):
    sd[f"{prefix}.weight"] = node["kernel"].T[:, :, None]
    sd[f"{prefix}.bias"] = node["bias"]


def _conv(sd, prefix, node):
    sd[f"{prefix}.weight"] = np.transpose(node["kernel"], (2, 1, 0))
    sd[f"{prefix}.bias"] = node["bias"]


def _convnext_layer(sd, prefix, node):
    _conv(sd, f"{prefix}.c1", node["dw"])
    sd[f"{prefix}.norm.gamma"] = node["norm"]["gamma"]
    sd[f"{prefix}.norm.beta"] = node["norm"]["beta"]
    _dense(sd, f"{prefix}.c2", node["pw1"])
    sd[f"{prefix}.grn.gamma"] = node["grn"]["gamma"].reshape(1, -1, 1)
    sd[f"{prefix}.grn.beta"] = node["grn"]["beta"].reshape(1, -1, 1)
    _dense(sd, f"{prefix}.c3", node["pw2"])


def _layers(sd, prefix, node):
    for name, sub in node.items():
        if name.startswith("layer_"):
            _convnext_layer(sd, f"{prefix}.mid_layers.{name[6:]}", sub)


def encoder_state_dict(tree):
    sd = {}
    for name in ("ssl_feature_estimator", "pitch_estimator"):
        stack = tree["params"][name]["stack"]
        _dense(sd, f"{name}.input_layer", stack["input_layer"])
        sd[f"{name}.norm.gamma"], sd[f"{name}.norm.beta"] = (stack["norm"]["gamma"],
                                                             stack["norm"]["beta"])
        _dense(sd, f"{name}.output_layer", stack["output_layer"])
        _layers(sd, name, stack)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def decoder_state_dict(tree):
    sd = {}
    src, filt = tree["params"]["source_net"], tree["params"]["filter_net"]
    for name in ("content_in", "energy_in", "f0_in", "to_amps", "to_kernel"):
        _dense(sd, f"source_net.{name}", src[name])
    _layers(sd, "source_net", src)
    _dense(sd, "filter_net.content_in", filt["content_in"])
    _dense(sd, "filter_net.f0_in", filt["f0_in"])
    _conv(sd, "filter_net.downs.0", filt["down_0"])
    _conv(sd, "filter_net.output_layer", filt["output_layer"])
    for i in range(1, 5):
        d, p = filt[f"down_{i}"], f"filter_net.downs.{i}"
        _dense(sd, f"{p}.down_res", d["down_res"])
        for c in ("c1", "c2", "c3"):
            _conv(sd, f"{p}.{c}", d[c])
    for i in range(5):
        u, p = filt[f"up_{i}"], f"filter_net.ups.{i}"
        for c in ("c1", "c2", "c3", "c4"):
            _conv(sd, f"{p}.{c}", u[c])
        _dense(sd, f"{p}.c5", u["c5"])
        for f in ("film1", "film2"):
            _dense(sd, f"{p}.{f}.to_scale", u[f]["to_scale"])
            _dense(sd, f"{p}.{f}.to_shift", u[f]["to_shift"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("pt")
    trees = {n: load_npz(os.path.join(MODELS, f"{n}_B.npz")) for n in ("encoder", "decoder")}
    torch.save(encoder_state_dict(trees["encoder"]), d / "encoder.pt")
    torch.save(decoder_state_dict(trees["decoder"]), d / "decoder.pt")
    return d, trees


def test_pt_loads_to_the_jax_tree_and_the_npz_tree(checkpoints):
    d, trees = checkpoints
    for name, port_fn, jax_fn, loader in (
            ("encoder", torch_compat.encoder_params_from_torch,
             jcompat.encoder_params_from_torch, model_store.load_encoder_params),
            ("decoder", torch_compat.decoder_params_from_torch,
             jcompat.decoder_params_from_torch, model_store.load_decoder_params)):
        sd = torch_compat.load_torch_checkpoint(str(d / f"{name}.pt"))
        _assert_same_tree(port_fn(sd), jax_fn(sd))
        _assert_same_tree(loader(str(d / f"{name}.pt")), trees[name])
        _assert_same_tree(loader(os.path.join(MODELS, f"{name}_B.npz")), trees[name])


def test_pt_weights_convert_as_the_npz_weights(checkpoints):
    d, trees = checkpoints
    wave = np.sin(2 * np.pi * 140.0 * np.arange(9600) / 24000).astype(np.float32) * 0.3
    index = model_store.load_index(os.path.join(MODELS, "index_B.npy"))
    outs = []
    for enc, dec in ((str(d / "encoder.pt"), str(d / "decoder.pt")),
                     (os.path.join(MODELS, "encoder_B.npz"),
                      os.path.join(MODELS, "decoder_B.npz"))):
        vc = VoiceConverter(model_store.load_encoder_params(enc),
                            model_store.load_decoder_params(dec), device="cpu")
        outs.append(vc.convert(wave, index, 11.99))
    assert np.isfinite(outs[0]).all() and np.abs(outs[0]).max() > 1e-3
    np.testing.assert_array_equal(outs[0], outs[1])


def test_reference_index_pt_is_transposed(tmp_path):
    ref = np.random.default_rng(3).standard_normal((1, 8, 30)).astype(np.float32)
    torch.save(torch.from_numpy(ref), tmp_path / "index.pt")
    got = model_store.load_index(str(tmp_path / "index.pt"))
    assert got.shape == (30, 8) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref[0].T)
    np.save(tmp_path / "index.npy", ref[0].T)
    np.testing.assert_array_equal(model_store.load_index(str(tmp_path / "index.npy")), ref[0].T)


def test_save_params_npz_round_trips(tmp_path):
    tree = {"params": {"a": {"kernel": np.ones((2, 3), np.float32)}, "b": np.arange(4.0)}}
    model_store.save_params_npz(str(tmp_path / "p.npz"), tree)
    _assert_same_tree(load_npz(str(tmp_path / "p.npz")), tree)


def test_checkpoint_directory_raises(tmp_path):
    with pytest.raises(ValueError, match="orbax.*ROADMAP"):
        model_store.load_encoder_params(str(tmp_path))
    with pytest.raises(ValueError, match="orbax.*ROADMAP"):
        model_store.load_decoder_params(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        model_store.load_decoder_params(str(tmp_path / "missing"))
