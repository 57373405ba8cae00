"""`infer/export.py` and `cli/export.py` on the CPU at the tests'
``small_config`` widths (`tests/test_training.py`): ``cli.export --device
cpu`` (``export_all(device="cpu")``) writes three ``torch.export`` programs
with symbolic batch and frames, and each loaded program equals JAX's
subgraph (``Encoder.apply``, ``Decoder.apply(method=source_net /
filter_net)``) on the same inputs and the port's eager module, at (b=1,
f=10) and at (b=3, the smallest f). A ``.pt2`` loads and runs in a process
that imports torch alone."""

import contextlib
import io
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyvc_tpu import config as jcfg
from tinyvc_tpu.models import Decoder as JDecoder
from tinyvc_tpu.models import Encoder as JEncoder
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.cli import export as cli_export
from tinyvc_tpu_torch.infer.export import MIN_FRAMES, export_all, load_exported
from tinyvc_tpu_torch.utils.model_store import save_params_npz
from tinyvc_tpu_torch.utils.weights import decoder_from_jax, encoder_from_jax
from torch_parity import numpy_params

# the widths of tests/test_training.py::small_config
ENC = dict(pitch_channels=16, pitch_num_layers=1, ssl_channels=16, ssl_dilations=(1,),
           ssl_dim=32)
DEC = dict(source_channels=16, source_num_layers=1, filter_channels=(32, 24, 16, 12, 8),
           content_channels=32)
HOP = 480
H2 = 14 + 2  # the default harmonics, the fundamental and the noise row
NAMES = ("encoder", "source_net", "filter_net")


@pytest.fixture(scope="module")
def models():
    je = JEncoder(jcfg.EncoderConfig(**ENC))
    jd = JDecoder(jcfg.DecoderConfig(**DEC), jcfg.AudioConfig())
    enc_p = numpy_params(je, jnp.zeros((1, 8, 961)))
    dec_p = numpy_params(jd, jnp.zeros((1, 8, 32)), jnp.full((1, 8), 100.0),
                         jnp.zeros((1, 8 * HOP)), jax.random.PRNGKey(0),
                         noise_angle=jnp.zeros((1, 8, 961)), seed=8)
    pc = pcfg.TinyVCConfig(encoder=pcfg.EncoderConfig(**ENC), decoder=pcfg.DecoderConfig(**DEC))
    jax_fns = {
        "encoder": jax.jit(je.apply),
        "source_net": jax.jit(lambda p, c, f, e: jd.apply(
            p, c, f, e, method=lambda m, c, f, e: m.source_net(c, f, e))),
        "filter_net": jax.jit(lambda p, c, f, e, s: jd.apply(
            p, c, f, e, s, method=lambda m, c, f, e, s: m.filter_net(c, f, e, s))),
    }
    enc = encoder_from_jax(enc_p, pc.encoder)
    dec = decoder_from_jax(dec_p, pc.decoder, pc.audio)
    eager = {
        "encoder": enc,
        "source_net": dec.source_net,
        "filter_net": lambda c, f, e, s: dec.filter_net(c, f, e, s.transpose(1, 2)),
    }
    return enc_p, dec_p, pc, jax_fns, eager


@pytest.fixture(scope="module")
def exported(models, tmp_path_factory):
    """``cli.export --device cpu`` on ``.npz`` exports of the trees, with
    the CLI's config at the small widths -> (paths, stdout, programs)."""
    enc_p, dec_p, pc = models[:3]
    tmp = tmp_path_factory.mktemp("exported")
    save_params_npz(str(tmp / "enc.npz"), enc_p)
    save_params_npz(str(tmp / "dec.npz"), dec_p)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(pcfg, "TinyVCConfig", lambda: pc)
        cli_export.main(["-o", str(tmp / "out"), "-encp", str(tmp / "enc.npz"),
                         "-decp", str(tmp / "dec.npz"), "--device", "cpu"])
    paths = {name: str(tmp / "out" / f"{name}.pt2") for name in NAMES}
    return paths, out.getvalue(), {name: load_exported(paths[name]) for name in NAMES}


def _inputs(name, B, F, seed=0):
    rng = np.random.default_rng(seed)
    if name == "encoder":
        return (np.abs(rng.standard_normal((B, F, 961))).astype(np.float32),)
    content = rng.standard_normal((B, F, 32)).astype(np.float32)
    f0 = rng.uniform(60.0, 300.0, (B, F)).astype(np.float32)
    energy = rng.uniform(0.0, 0.5, (B, F * HOP)).astype(np.float32)
    if name == "source_net":
        return content, f0, energy
    source = 0.3 * rng.standard_normal((B, F * HOP, H2))
    return content, f0, energy, source.astype(np.float32)


def test_cli_export_writes_three_symbolic_programs(exported):
    paths, stdout, _ = exported
    lines = [f"{name}: {paths[name]}" for name in NAMES] + ["symbolic: True"]
    assert stdout.splitlines() == lines
    for name in NAMES:
        assert os.path.getsize(paths[name]) > 0


def test_export_all_refuses_an_example_below_the_smallest_f(tmp_path):
    with pytest.raises(ValueError, match="example_frames"):
        export_all({}, {}, str(tmp_path), example_frames=MIN_FRAMES - 1, device="cpu")


@pytest.mark.parametrize("B,F", ((1, 10), (3, MIN_FRAMES)))
@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax_and_the_eager_module(models, exported, name, B, F):
    enc_p, dec_p, _, jax_fns, eager = models
    args = _inputs(name, B, F)
    got = exported[2][name](*args)
    want = jax_fns[name](enc_p if name == "encoder" else dec_p, *args)
    with torch.inference_mode():
        mine = eager[name](*(torch.from_numpy(a) for a in args))
    if name == "filter_net":
        got, want, mine = (got,), (want,), (mine,)
    assert len(got) == len(want) == len(mine)
    for g, w, m in zip(got, want, mine):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        peak = float(np.abs(w).max())
        # fp32 sums in two libraries' orders
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * peak
        # the program is the module's own operations (measured 0)
        assert float((g - m).abs().max()) <= 1e-6 * float(m.abs().max())


def test_load_exported_keeps_a_program_on_its_device(exported):
    assert exported[2]["encoder"].device == torch.device("cpu")
    assert load_exported(exported[0]["source_net"], device="cpu").device == torch.device("cpu")


def test_program_refuses_fewer_frames(exported):
    with pytest.raises(Exception):
        exported[2]["source_net"](*_inputs("source_net", 2, MIN_FRAMES - 1))


def test_program_loads_in_a_process_that_imports_torch_alone(exported, tmp_path):
    args = _inputs("source_net", 2, MIN_FRAMES + 1, seed=3)
    np.savez(tmp_path / "args.npz", *args)
    want = exported[2]["source_net"](*args)[0].numpy()
    np.save(tmp_path / "want.npy", want)
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        program = torch.export.load({exported[0]["source_net"]!r}).module()
        with np.load("args.npz") as data:
            args = [torch.from_numpy(data[f"arr_{{i}}"]) for i in range(3)]
        with torch.inference_mode():
            out = program(*args)[0].numpy()
        assert np.array_equal(out, np.load("want.npy")), "the output moved"
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "tinyvc_tpu",
                                                                "tinyvc_tpu_torch")]
        assert not loaded, loaded
        print("ok", out.shape)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == f"ok {want.shape}"
