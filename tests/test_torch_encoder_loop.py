"""The port's training loops beyond one step: `train/loop.py::train_encoder`
against the JAX package's over one epoch of a 4-chunk cache with cached
teacher features, per step from the Python loader and from the
device-resident cache (the JAX package's batches and keys); resuming; the
K-step windows of `train/multi_step.py` against K single steps (bit for
bit) and the encoder's against JAX's ``make_encoder_multi_step``;
``effective_k``; and ``cli.train_encoder --device cpu`` at the shipped
widths: it trains, logs, saves and resumes, with and without ``--device-data
-K``, needs CUDA unless the CPU is asked for, and takes the multi-host flags
(one process without a group; two gloo ranks).

Both loops start from one state: JAX's initial state is written as the
port's checkpoint, so the port resumes from it. Bounds, measured before
they were fixed: the parameters 1e-5 absolute after two AdamW steps at lr
1e-4 (measured 6.6e-7), the logged losses 1e-6 relative (3.3e-7); the
encoder's window against JAX's the same."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_training import small_config
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.train import decoder_train as pdt
from tinyvc_tpu_torch.train import encoder_train as pet
from tinyvc_tpu_torch.train import loop as ploop
from tinyvc_tpu_torch.train import multi_step as pms
from tinyvc_tpu_torch.train.teacher import MFCCTeacher
from tinyvc_tpu_torch.utils import prng
from tinyvc_tpu_torch.utils.audio_io import load_audio, save_wav
from tinyvc_tpu_torch.utils.checkpoint import CheckpointManager
from tinyvc_tpu_torch.utils.weights import (encoder_train_state_from_jax, jax_name,
                                            to_jax_layout)
from test_torch_encoder_train import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-6
L, F = 4800, 10
OFFLINE = {"HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1"}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demo():
    return load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))[0][0]


@pytest.fixture()
def cache(tmp_path, demo):
    """Four 0.2 s chunks of the demo, voiced f0 with unvoiced frames, and
    teacher features of 7 frames at the small width (32)."""
    d = tmp_path / "cache"
    d.mkdir()
    rng = np.random.default_rng(4)
    for i in range(4):
        save_wav(str(d / f"{i}.wav"), demo[9000 * i + 3000: 9000 * i + 3000 + L])
        f0 = rng.uniform(80, 300, F).astype(np.float32)
        f0[:2] = 0.0
        np.save(d / f"{i}.f0.npy", f0)
        np.save(d / f"{i}.teacher.npy", (0.3 * rng.standard_normal((7, 32))).astype(np.float32))
    return str(d)


def _configs(**train):
    jc = small_config()
    jc = dataclasses.replace(jc, train=dataclasses.replace(jc.train, **train))
    pc = port_config()
    return jc, dataclasses.replace(pc, train=dataclasses.replace(pc.train, **train))


def _leaf(tree, name):
    for part in jax_name(name).split("/"):
        tree = tree[part]
    return np.asarray(tree)


def _losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [(r["step"], r["loss/Pitch Estimation"], r["loss/Distillation"])
                for r in map(json.loads, f)]


def _run_both(cache, tmp_path, monkeypatch, device_data):
    from tinyvc_tpu.train import encoder_train as jet
    from tinyvc_tpu.train.loop import train_encoder as jax_train_encoder

    monkeypatch.setenv("TINYVC_NO_NATIVE_LOADER", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    # JAX's writer falls back to its JSON lines without TensorBoard, whose
    # import pulls in TensorFlow (~15 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    jc, pc = _configs(log_interval=1, save_interval=1000)
    _, init = jet.init_state(jc, jax.random.PRNGKey(0))
    port_ckpt = str(tmp_path / "port_ckpt")
    CheckpointManager(port_ckpt).save(0, encoder_train_state_from_jax(jax.device_get(init),
                                                                      pc.encoder))
    kw = dict(dataset_dir=cache, epochs=1, device_data=device_data, steps_per_dispatch=1)
    want = jax.device_get(jax_train_encoder(jc, ckpt_dir=str(tmp_path / "jax_ckpt"),
                                            log_dir=str(tmp_path / "jax_logs"), **kw))
    got = ploop.train_encoder(pc, ckpt_dir=port_ckpt, log_dir=str(tmp_path / "port_logs"),
                              device="cpu", **kw)
    assert got.step == int(want.step) == 2
    worst = max(np.abs(to_jax_layout(p, n) - _leaf(want.params, n)).max()
                for n, p in got.encoder.named_parameters())
    print(f"device_data={device_data}: parameters within {worst:.2e}")
    assert worst <= PARAM_ATOL
    jl, pl = _losses(str(tmp_path / "jax_logs")), _losses(str(tmp_path / "port_logs"))
    assert [r[0] for r in pl] == [r[0] for r in jl] == [1, 2]
    for a, b in zip(pl, jl):
        assert all(abs(x - y) <= LOSS_RTOL * abs(y) for x, y in zip(a[1:], b[1:])), (a, b)
    return got, port_ckpt


@pytest.mark.parametrize("device_data", [False, True], ids=["python_loader", "device_data"])
def test_train_encoder_matches_jax(cache, tmp_path, monkeypatch, capsys, device_data):
    got, ckpt = _run_both(cache, tmp_path, monkeypatch, device_data)
    out = capsys.readouterr().out
    assert ("device-resident dataset: 4 chunks" in out) == device_data
    assert CheckpointManager(ckpt).steps() == [0, 2]
    # resume: one more epoch from the saved step 2
    pc = dataclasses.replace(port_config(), train=dataclasses.replace(
        port_config().train, log_interval=1, save_interval=1000))
    again = ploop.train_encoder(pc, dataset_dir=cache, ckpt_dir=ckpt, epochs=1,
                                log_dir=str(tmp_path / "port_logs"), device="cpu",
                                device_data=device_data, steps_per_dispatch=1)
    assert "resumed encoder training at step 2" in capsys.readouterr().out
    assert again.step == 4 and again.opt.count == 4
    assert [r[0] for r in _losses(str(tmp_path / "port_logs"))] == [1, 2, 3, 4]
    assert CheckpointManager(ckpt).steps() == [0, 2, 4]


def test_cached_teacher_needs_the_python_loader(cache, tmp_path, monkeypatch):
    from tinyvc_tpu_torch.data import native_loader

    if native_loader.load_library() is None:
        pytest.skip("the native library does not build here")
    monkeypatch.delenv("TINYVC_NO_NATIVE_LOADER", raising=False)
    _, pc = _configs()
    with pytest.raises(RuntimeError, match="TINYVC_NO_NATIVE_LOADER=1"):
        ploop.train_encoder(pc, dataset_dir=cache, ckpt_dir=str(tmp_path / "c"), epochs=1,
                            log_dir=str(tmp_path / "l"), device="cpu")


def _cache_tensors(cache, teacher=True):
    waves = np.stack([load_audio(os.path.join(cache, f"{i}.wav"))[0][0] for i in range(4)])
    f0s = np.stack([np.load(os.path.join(cache, f"{i}.f0.npy")) for i in range(4)])
    tf = np.stack([np.load(os.path.join(cache, f"{i}.teacher.npy")) for i in range(4)])
    return waves.astype(np.float32), f0s, tf


def _window_inputs(K, B, seed=3):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(4, size=B, replace=False) for _ in range(K)])
    keys = prng.split(prng.prng_key(9), K + 1)
    return idx, keys[1:]


@pytest.mark.parametrize("distill", [True, False], ids=["distill", "pitch_only"])
def test_encoder_window_is_k_single_steps(cache, distill):
    _, pc = _configs()
    waves, f0s, tf = (torch.from_numpy(a) for a in _cache_tensors(cache))
    idx, keys = _window_inputs(3, 2)
    a = pet.init_state(pc, 1, "cpu")
    b = pet.init_state(pc, 1, "cpu")
    m = pms.make_encoder_multi_step(pc, distill)(a, waves, f0s, tf if distill else None,
                                                 torch.from_numpy(idx), keys)
    step = pet.make_train_step(pc, distill)
    for i, k in zip(idx, keys):
        last = step(b, waves[i], f0s[i], tf[i] if distill else None, k)
    assert a.step == b.step == 3 and a.opt.count == b.opt.count == 3
    for (n, p), q in zip(a.encoder.named_parameters(), b.encoder.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(a.opt.mu[n], b.opt.mu[n]) and torch.equal(a.opt.nu[n], b.opt.nu[n])
    assert all(torch.equal(m[k], last[k]) for k in last)


def test_encoder_window_matches_jax(cache):
    from tinyvc_tpu.train import encoder_train as jet
    from tinyvc_tpu.train.multi_step import make_encoder_multi_step

    jc, pc = _configs()
    waves, f0s, tf = _cache_tensors(cache)
    idx, keys = _window_inputs(3, 2)
    _, js = jet.init_state(jc, jax.random.PRNGKey(2))
    ps = encoder_train_state_from_jax(jax.device_get(js), pc.encoder)
    js, jm = make_encoder_multi_step(jc, distill=True)(
        js, jnp.asarray(waves), jnp.asarray(f0s), jnp.asarray(tf), jnp.asarray(idx, jnp.int32),
        jnp.asarray(keys))
    pm = pms.make_encoder_multi_step(pc, True)(ps, torch.from_numpy(waves), torch.from_numpy(f0s),
                                               torch.from_numpy(tf), torch.from_numpy(idx), keys)
    js = jax.device_get(js)
    assert ps.step == int(js.step) == 3
    for n, p in ps.encoder.named_parameters():
        assert np.abs(to_jax_layout(p, n) - _leaf(js.params, n)).max() <= PARAM_ATOL, n
    for k in ("loss_f0", "loss_distill", "loss"):
        assert abs(float(pm[k]) - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k])), k


SMALL_DISC = pcfg.DiscriminatorConfig(periods=(2, 3), resolutions=(32,), channels=4,
                                      max_channels=16, num_layers=2)


@pytest.mark.parametrize("d_join", [False, True], ids=["pre_join", "post_join"])
def test_decoder_window_is_k_single_steps(cache, d_join):
    cfg = pcfg.TinyVCConfig(
        encoder=port_config().encoder,
        decoder=pcfg.DecoderConfig(source_channels=16, source_num_layers=1,
                                   filter_channels=(32, 24, 16, 12, 8), content_channels=32),
        discriminator=SMALL_DISC, train=pcfg.TrainConfig(batch_size=2, chunk_length=L,
                                                         disc_crop=2400))
    waves = torch.from_numpy(_cache_tensors(cache)[0])
    idx, keys = _window_inputs(2, 2)
    enc = ploop.load_encoder(None, cfg, 0, "cpu")
    a, b = pdt.init_state(cfg, 1, "cpu"), pdt.init_state(cfg, 1, "cpu")
    m = pms.make_decoder_multi_step(cfg, d_join, "mel")(a, enc, waves, torch.from_numpy(idx),
                                                        keys)
    step = pdt.make_train_step(cfg, d_join, "mel")
    singles = [step(b, enc, waves[i], k) for i, k in zip(idx, keys)]
    assert a.step == b.step == 2
    for net in ("decoder", "discriminator"):
        for (n, p), q in zip(getattr(a, net).named_parameters(),
                             getattr(b, net).parameters()):
            assert torch.equal(p, q), (net, n)
    for k, v in m.items():
        if k.startswith("skipped"):
            assert v == sum(s[k] for s in singles) == 0
        else:
            assert torch.equal(v, singles[-1][k]), k


def test_effective_k_divides_every_boundary():
    assert pms.effective_k(50, 50, 500, 10000, 30000) == 50
    assert pms.effective_k(50, 50, 500, 10000, 30000, 0) == 50  # 0: no boundary
    assert pms.effective_k(50, 50, 500, 960) == 10
    assert pms.effective_k(7, 50, 500) == 1
    assert pms.effective_k(0) == 1
    assert pms.effective_k(100, 50) == 50
    from tinyvc_tpu.train.multi_step import effective_k

    for case in ((50, 50, 500, 960), (12, 8, 0, 30), (3, 2), (9,)):
        assert pms.effective_k(*case) == effective_k(*case)


@pytest.fixture(scope="module")
def full_cache(tmp_path_factory, demo):
    """Three 2 s chunks of the demo with MFCC teacher features: the CLI
    trains at the shipped widths and chunk length."""
    d = tmp_path_factory.mktemp("full")
    feats = MFCCTeacher()(demo[None, :144000].reshape(3, 48000))
    for i in range(3):
        save_wav(str(d / f"{i}.wav"), demo[48000 * i: 48000 * (i + 1)])
        np.save(d / f"{i}.f0.npy", np.full(100, 150.0, np.float32))
        np.save(d / f"{i}.teacher.npy", feats[i])
    return str(d)


def _cli(args, cwd, **env):
    return subprocess.run([sys.executable, "-m", "tinyvc_tpu_torch.cli.train_encoder", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=600,
                          env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2",
                               **OFFLINE, **env})


def test_cli_trains_logs_saves_and_resumes(full_cache, tmp_path):
    ckpt, logs = tmp_path / "enc", tmp_path / "logs"
    args = ["--dataset-cache", full_cache, "-path", str(ckpt), "--log-dir", str(logs), "-b", "2",
            "-e", "2", "--log-interval", "1", "--save-interval", "2", "--device", "cpu"]
    proc = _cli(args, tmp_path, TINYVC_NO_NATIVE_LOADER="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "using the Python DataLoader" in proc.stdout
    printed = [ln for ln in proc.stdout.splitlines() if ln.startswith("epoch ")]
    assert len(printed) == 2 and "distill=" in printed[0]  # one step an epoch: 3 // 2
    lines = _losses(str(logs))
    assert [r[0] for r in lines] == [1, 2] and all(np.isfinite(r[1:]).all() for r in lines)
    assert CheckpointManager(str(ckpt)).steps() == [2]
    saved = torch.load(ckpt / "2" / "state.pt", weights_only=False)
    assert saved["step"] == 2 and saved["opt/count"] == 2
    assert saved["params/ssl_feature_estimator/stack/layer_0/pw1/kernel"].shape == (384, 768)
    # resumed from step 2 on the device-resident cache, two steps per window
    proc = _cli(args + ["--device-data", "-K", "2", "--log-interval", "2", "--save-interval",
                        "4"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed encoder training at step 2" in proc.stdout
    assert "multi-step dispatch: K=2 steps per device call" in proc.stdout
    assert [r[0] for r in _losses(str(logs))] == [1, 2, 4]
    assert CheckpointManager(str(ckpt)).steps()[-1] == 4
    assert torch.load(ckpt / "4" / "state.pt", weights_only=False)["opt/count"] == 4


def test_cli_needs_cuda_unless_cpu_is_asked_for(full_cache, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = _cli(["--dataset-cache", full_cache, "-path", str(tmp_path / "c"), "-e", "1"],
                tmp_path)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert not (tmp_path / "c").exists() or not os.listdir(tmp_path / "c")


def test_cli_single_process_flags_train_without_a_group(full_cache, tmp_path, monkeypatch):
    """``--num-processes 1 --process-id 0`` (JAX's single-host form) forms
    no process group and trains one process."""
    import torch.distributed as dist

    from tinyvc_tpu_torch.cli import train_encoder as cli

    monkeypatch.setenv("TINYVC_NO_NATIVE_LOADER", "1")
    ckpt = tmp_path / "enc"
    cli.main(["--dataset-cache", full_cache, "-path", str(ckpt), "--log-dir",
              str(tmp_path / "logs"), "-b", "2", "-e", "1", "--device", "cpu",
              "--num-processes", "1", "--process-id", "0"])
    assert not dist.is_initialized()
    assert CheckpointManager(str(ckpt)).steps() == [1]


def test_cli_two_processes_need_an_address(capsys):
    from tinyvc_tpu_torch.cli import train_encoder as cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--num-processes", "2", "--process-id", "0"])
    assert e.value.code == 2 and "need --coordinator-address" in capsys.readouterr().err


@pytest.mark.parametrize("batch", [3, 2])
def test_cli_on_two_ranks(full_cache, tmp_path, batch):
    """Two gloo ranks: a global batch that does not divide the world fails
    on both with JAX's message; one that does trains data-parallel, rank 0
    alone logging (3 chunks, a row a rank: 3 steps) and saving once."""
    from torch_dist import launch

    ckpt, logs = tmp_path / "enc", tmp_path / "logs"
    flags = ["--dataset-cache", full_cache, "-path", str(ckpt), "--log-dir", str(logs),
             "-b", str(batch), "-e", "1", "--log-interval", "1", "--save-interval", "3"]
    results = launch(tmp_path / "run", [{"name": "cli", "kind": "cli",
                                         "args": {"cli": "train_encoder", "flags": flags}}],
                     timeout=240)
    if batch == 3:
        for code, _, err in results:
            assert code != 0 and "global batch (3) divisible by the global device count (2)" in err
        return
    for r, (code, out, err) in enumerate(results):
        assert code == 0, err[-3000:]
        assert ("epoch 0 step 3" in out) == (r == 0)
    assert [row[0] for row in _losses(str(logs))] == [1, 2, 3]
    assert CheckpointManager(str(ckpt)).steps() == [3]
