"""The port's decoder training loop and its CLI on a small cache written
here in the JAX package's format (``{i}.wav`` at 24 kHz, ``{i}.f0.npy``):
the batch order against the JAX package's loader, the checkpoint round
trip (with and without a discriminator), three steps through ``python -m
tinyvc_tpu_torch.cli.train_decoder --device cpu`` at the shipped widths
across the discriminator's join, logging, saving, resuming with both
networks' moments restored; no CUDA by default; ``--remat``; the
multi-host flags (one process without a group, incomplete flags refused,
two gloo ranks). The CLI's runs take the Python loader
(``TINYVC_NO_NATIVE_LOADER``): the native one pads every 0.4 s chunk to the
config's 2 s, as the JAX package's does. `tests/test_torch_train_device_data.py`
runs the device-resident cache."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.cli import train_decoder as cli
from tinyvc_tpu_torch.data.dataset import DataLoader, Dataset
from tinyvc_tpu_torch.train import decoder_train as pdt
from tinyvc_tpu_torch.utils.audio_io import load_audio, save_wav
from tinyvc_tpu_torch.utils.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models", "two_speaker")
CHUNK = 9600  # 0.4 s chunks: F = 20 frames


@pytest.fixture(autouse=True)
def _two_threads():
    """At most two intra-op threads per test: the tier-1 run puts six workers
    on the CPU's cores, where more threads per worker only spin against each
    other's (a full-width discriminator test took 300x its single-process
    time so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """Five chunks cut from the demo utterance at staggered offsets."""
    d = tmp_path_factory.mktemp("cache")
    wave = load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))[0][0]
    for i in range(5):
        save_wav(str(d / f"{i}.wav"), wave[7000 * i: 7000 * i + CHUNK])
        np.save(d / f"{i}.f0.npy", np.full(CHUNK // 480, 150.0, np.float32))
    return str(d)


def test_batches_follow_the_jax_loaders_order(cache):
    from tinyvc_tpu.data.dataset import DataLoader as JaxLoader
    from tinyvc_tpu.data.dataset import Dataset as JaxDataset

    for seed in (0, 3):
        port = DataLoader(Dataset(cache), 2, seed=seed)
        jl = JaxLoader(JaxDataset(cache), 2, shuffle=True, seed=seed)
        for _ in range(2):  # two passes: each draws its order from the one generator
            assert [b["idx"].tolist() for b in port] == [b["idx"].tolist() for b in jl]
    batch = next(iter(DataLoader(Dataset(cache), 2)))
    assert batch["wave"].shape == (2, CHUNK) and batch["f0"].shape == (2, 20)


SMALL_DISC = pcfg.DiscriminatorConfig(periods=(2, 3), resolutions=(32,), channels=4,
                                      max_channels=16, num_layers=2)


def _small_cfg():
    return pcfg.TinyVCConfig(decoder=pcfg.DecoderConfig(
        source_channels=16, source_num_layers=1, filter_channels=(32, 24, 16, 12, 8),
        content_channels=32), discriminator=SMALL_DISC)


def test_checkpoint_round_trip(tmp_path):
    cfg = _small_cfg()
    st = pdt.init_state(cfg, 1, "cpu")
    for opt in (st.gen_opt, st.disc_opt):
        for t in opt.mu.values():
            t.normal_()
    st.gen_opt.count, st.gen_opt.notfinite_count, st.step = 7, 2, 9
    st.disc_opt.count, st.disc_opt.notfinite_count = 5, 1
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (3, 6, 9):
        ckpt.save(step, st, cfg)
    assert ckpt.steps() == [6, 9]
    tree = torch.load(tmp_path / "9" / "state.pt", weights_only=False)
    kernel = tree["gen_params/params/filter_net/up_4/c1/kernel"]
    assert kernel.shape == (3, 8, 8)  # flax's [K, Cin, Co]
    assert tree["disc_params/params/mrd_32/conv_1/v"].shape == (5, 3, 4, 8)  # HWIO
    fresh = pdt.init_state(cfg, 2, "cpu")
    assert ckpt.restore(fresh) is fresh
    for net, opt, fnet, fopt in ((st.decoder, st.gen_opt, fresh.decoder, fresh.gen_opt),
                                 (st.discriminator, st.disc_opt, fresh.discriminator,
                                  fresh.disc_opt)):
        for (n, p), q in zip(net.named_parameters(), fnet.parameters()):
            assert torch.equal(p, q), n
            assert torch.equal(opt.mu[n], fopt.mu[n]) and torch.equal(opt.nu[n], fopt.nu[n])
    assert (fresh.gen_opt.count, fresh.gen_opt.notfinite_count, fresh.step) == (7, 2, 9)
    assert (fresh.disc_opt.count, fresh.disc_opt.notfinite_count) == (5, 1)


def test_checkpoint_without_a_discriminator_restores(tmp_path, capsys):
    """A checkpoint of a state without a discriminator (as the pre-join
    port wrote them) restores the generator and keeps the state's freshly
    drawn discriminator, saying so."""
    cfg = _small_cfg()
    old = pdt.init_state(cfg, 1, "cpu")
    old = pdt.TrainState(old.decoder, old.gen_opt, step=4)
    CheckpointManager(str(tmp_path)).save(4, old, cfg)
    tree = torch.load(tmp_path / "4" / "state.pt", weights_only=False)
    assert not any(k.startswith("disc_") for k in tree)
    fresh = pdt.init_state(cfg, 2, "cpu")
    disc = {n: p.detach().clone() for n, p in fresh.discriminator.named_parameters()}
    assert CheckpointManager(str(tmp_path)).restore(fresh) is fresh
    assert "holds no discriminator" in capsys.readouterr().out
    assert all(torch.equal(p, q) for p, q in zip(old.decoder.parameters(),
                                                 fresh.decoder.parameters()))
    assert all(torch.equal(p, disc[n]) for n, p in fresh.discriminator.named_parameters())
    assert fresh.step == 4 and fresh.disc_opt.count == 0


def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "tinyvc_tpu_torch.cli.train_decoder", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=600,
                          env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2",
                               "TINYVC_NO_NATIVE_LOADER": "1"})


def test_cli_trains_logs_saves_and_resumes_across_the_join(cache, tmp_path, monkeypatch):
    """``-d-join 2 -step 3``: steps 1 and 2 pre-join, step 3 post-join with
    the shipped discriminator; then one more post-join step resumed in
    process from the checkpoint of step 3, both networks' moments and
    counts restored."""
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    args = ["--dataset-cache", cache, "-encp", os.path.join(MODELS, "encoder_B.npz"),
            "--init-decoder", os.path.join(MODELS, "decoder_B.npz"), "-decp", str(ckpt),
            "--log-dir", str(logs), "-b", "2", "--log-interval", "1", "--save-interval", "2",
            "-d-join", "2", "-spec-type", "mel"]
    proc = _run(args + ["-step", "3", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = [ln for ln in proc.stdout.splitlines() if ln.startswith("step ")]
    assert [" d=" in ln for ln in printed] == [False, False, True]
    lines = [json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(np.isfinite(r["loss/Spectrogram"]) and np.isfinite(r["loss/DSP"]) for r in lines)
    adv = ("loss/Generator Adversarial", "loss/Feature Matching", "loss/Discriminator Adversarial")
    assert not any(t in r for r in lines[:2] for t in adv)
    assert all(np.isfinite(lines[2][t]) for t in adv)
    assert CheckpointManager(str(ckpt)).steps() == [2, 3]
    saved = torch.load(ckpt / "3" / "state.pt", weights_only=False)
    assert saved["step"] == 3 and saved["gen_opt/count"] == 3 and saved["disc_opt/count"] == 1
    assert saved["gen_opt/notfinite_count"] == 0 and saved["disc_opt/notfinite_count"] == 0
    assert saved["disc_params/params/mrd_256/post/v"].shape == (3, 3, 256, 1)
    init = np.load(os.path.join(MODELS, "decoder_B.npz"))
    name = "params/filter_net/up_4/c1/kernel"
    assert not np.array_equal(saved[f"gen_params/{name}"], init[name])  # trained

    # resume in process: the state of step 3, both networks' moments and
    # all, then one more post-join step
    cfg = pcfg.TinyVCConfig(train=pcfg.TrainConfig(batch_size=2))
    st = pdt.init_state(cfg, 0, "cpu")
    CheckpointManager(str(ckpt)).restore(st)
    assert st.step == 3 and st.gen_opt.count == 3 and st.disc_opt.count == 1
    assert any(float(t.abs().max()) > 0 for t in st.disc_opt.nu.values())
    monkeypatch.setenv("TINYVC_NO_NATIVE_LOADER", "1")
    cli.main(args + ["-step", "4", "--device", "cpu"])
    assert CheckpointManager(str(ckpt)).steps()[-1] == 4
    resumed = torch.load(ckpt / "4" / "state.pt", weights_only=False)
    assert resumed["step"] == 4 and resumed["gen_opt/count"] == 4
    assert resumed["disc_opt/count"] == 2
    lines = [json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3, 4] and all(t in lines[3] for t in adv)


def test_cli_needs_cuda_unless_cpu_is_asked_for(cache, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = _run(["--dataset-cache", cache, "-step", "1", "-decp", str(tmp_path / "c")], tmp_path)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("remat", [True, False])
def test_cli_remat_reaches_the_config(remat, monkeypatch):
    from tinyvc_tpu_torch.train import loop

    seen = {}
    monkeypatch.setattr(loop, "train_decoder", lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    cli.main(["--device", "cpu"] + (["--remat"] if remat else []))
    assert seen["cfg"].decoder.remat is remat and seen["device"] == "cpu"


def test_cli_single_process_flags_train_without_a_group(cache, tmp_path, monkeypatch):
    """``--num-processes 1 --process-id 0`` (JAX's single-host form) forms
    no process group and trains one process."""
    import torch.distributed as dist

    monkeypatch.setenv("TINYVC_NO_NATIVE_LOADER", "1")
    ckpt = tmp_path / "ckpt"
    cli.main(["--dataset-cache", cache, "-encp", os.path.join(MODELS, "encoder_B.npz"),
              "--init-decoder", os.path.join(MODELS, "decoder_B.npz"), "-decp", str(ckpt),
              "--log-dir", str(tmp_path / "logs"), "-b", "2", "-step", "1", "-spec-type",
              "mel", "--device", "cpu", "--num-processes", "1", "--process-id", "0"])
    assert not dist.is_initialized()
    assert CheckpointManager(str(ckpt)).steps() == [1]


@pytest.mark.parametrize("flags,message", [
    (["--num-processes", "2", "--process-id", "0"], "need --coordinator-address"),
    (["--num-processes", "2", "--coordinator-address", "localhost:1"], "--process-id must be"),
    (["--num-processes", "2", "--process-id", "2", "--coordinator-address", "localhost:1"],
     "--process-id must be in [0, 2)"),
])
def test_cli_rejects_incomplete_multi_host_flags(flags, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", *flags])
    assert e.value.code == 2 and message in capsys.readouterr().err


@pytest.mark.parametrize("batch", [3, 2])
def test_cli_on_two_ranks(cache, tmp_path, batch):
    """Two gloo ranks: a global batch that does not divide the world fails
    on both with JAX's message; one that does trains data-parallel from the
    shipped weights, rank 0 alone logging, one checkpoint."""
    from torch_dist import launch

    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    flags = ["--dataset-cache", cache, "-encp", os.path.join(MODELS, "encoder_B.npz"),
             "--init-decoder", os.path.join(MODELS, "decoder_B.npz"), "-decp", str(ckpt),
             "--log-dir", str(logs), "-b", str(batch), "-step", "1", "--log-interval", "1",
             "-spec-type", "mel"]
    results = launch(tmp_path / "run", [{"name": "cli", "kind": "cli",
                                         "args": {"cli": "train_decoder", "flags": flags}}],
                     timeout=240)
    if batch == 3:
        for code, _, err in results:
            assert code != 0 and "global batch (3) divisible by the global device count (2)" in err
        return
    for r, (code, out, err) in enumerate(results):
        assert code == 0, err[-3000:]
        assert ("step 1 spec=" in out) == (r == 0)
    lines = [json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1]
    assert CheckpointManager(str(ckpt)).steps() == [1]
