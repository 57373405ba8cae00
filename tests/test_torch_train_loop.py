"""The port's decoder training loop and its CLI on a small cache written
here in the JAX package's format (``{i}.wav`` at 24 kHz, ``{i}.f0.npy``):
the batch order against the JAX package's loader, the checkpoint round
trip, three steps through ``python -m tinyvc_tpu_torch.cli.train_decoder
--device cpu`` at the shipped widths, logging, saving, resuming with the
moments restored, and the refusals (no CUDA by default, the discriminator
join, the flags of later slices)."""

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


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """Five chunks cut from the demo utterance at staggered offsets."""
    d = tmp_path_factory.mktemp("cache")
    wave = load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))
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


def test_checkpoint_round_trip(tmp_path):
    cfg = pcfg.TinyVCConfig(decoder=pcfg.DecoderConfig(
        source_channels=16, source_num_layers=1, filter_channels=(32, 24, 16, 12, 8),
        content_channels=32))
    st = pdt.init_state(cfg, 1)
    for t in st.mu.values():
        t.normal_()
    st.count, st.notfinite_count, st.step = 7, 2, 9
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (3, 6, 9):
        ckpt.save(step, st, cfg)
    assert ckpt.steps() == [6, 9]
    tree = torch.load(tmp_path / "9" / "state.pt", weights_only=False)
    kernel = tree["gen_params/params/filter_net/up_4/c1/kernel"]
    assert kernel.shape == (3, 8, 8)  # flax's [K, Cin, Co]
    fresh = pdt.init_state(cfg, 2)
    assert ckpt.restore(fresh) is fresh
    for (n, p), q in zip(st.decoder.named_parameters(), fresh.decoder.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(st.mu[n], fresh.mu[n]) and torch.equal(st.nu[n], fresh.nu[n])
    assert (fresh.count, fresh.notfinite_count, fresh.step) == (7, 2, 9)


def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "tinyvc_tpu_torch.cli.train_decoder", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=600,
                          env={**os.environ, "PYTHONPATH": ROOT})


def test_cli_trains_logs_saves_resumes_and_refuses_the_join(cache, tmp_path):
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    args = ["--dataset-cache", cache, "-encp", os.path.join(MODELS, "encoder_B.npz"),
            "--init-decoder", os.path.join(MODELS, "decoder_B.npz"), "-decp", str(ckpt),
            "--log-dir", str(logs), "-b", "2", "--log-interval", "1", "--save-interval", "2"]
    proc = _run(args + ["-step", "3", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(np.isfinite(r["loss/Spectrogram"]) and np.isfinite(r["loss/DSP"]) for r in lines)
    assert CheckpointManager(str(ckpt)).steps() == [2, 3]
    saved = torch.load(ckpt / "3" / "state.pt", weights_only=False)
    assert saved["step"] == 3 and saved["gen_opt/count"] == 3
    assert saved["gen_opt/notfinite_count"] == 0
    init = np.load(os.path.join(MODELS, "decoder_B.npz"))
    name = "params/filter_net/up_4/c1/kernel"
    assert not np.array_equal(saved[f"gen_params/{name}"], init[name])  # trained

    # resume in process: the state of step 3, moments and all, then one
    # more step, and the join at step 4 refuses the next
    cfg = pcfg.TinyVCConfig(train=pcfg.TrainConfig(batch_size=2))
    st = pdt.init_state(cfg, 0)
    CheckpointManager(str(ckpt)).restore(st)
    nu = {n: t.clone() for n, t in st.nu.items()}
    assert st.step == 3 and st.count == 3 and any(float(t.abs().max()) > 0 for t in nu.values())
    with pytest.raises(NotImplementedError, match="discriminator_join"):
        cli.main(args + ["-step", "10", "-d-join", "4", "--device", "cpu"])
    steps = CheckpointManager(str(ckpt)).steps()
    assert steps[-1] == 4
    resumed = torch.load(ckpt / "4" / "state.pt", weights_only=False)
    assert resumed["step"] == 4 and resumed["gen_opt/count"] == 4
    lines = [json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]


def test_cli_needs_cuda_unless_cpu_is_asked_for(cache, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = _run(["--dataset-cache", cache, "-step", "1", "-decp", str(tmp_path / "c")], tmp_path)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("flag", [["--remat"], ["--device-data"], ["-K", "4"],
                                  ["--num-processes", "2"]])
def test_cli_refuses_later_slices_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", *flag])
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err
