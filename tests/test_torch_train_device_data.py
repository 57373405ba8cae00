"""``python -m tinyvc_tpu_torch.cli.train_decoder --device cpu`` on the
device-resident cache (``--device-data``), one step at a time and two steps
a window (``-K 2``), from an encoder checkpoint directory of the port's
encoder training (``-encp``): it trains, logs, saves and resumes at the
shipped widths on 2 s chunks, the config's chunk length; and such a
directory loads as the ``.npz`` it was written from."""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_train_loop import MODELS, ROOT, _run, _two_threads  # noqa: F401
from tinyvc_tpu_torch import config as pcfg
from tinyvc_tpu_torch.train import decoder_train as pdt
from tinyvc_tpu_torch.utils.audio_io import load_audio, save_wav
from tinyvc_tpu_torch.utils.checkpoint import CheckpointManager


@pytest.fixture(scope="module")
def encoder_dir(tmp_path_factory):
    """The two-speaker encoder as a checkpoint directory of the port's
    encoder training (`utils/checkpoint.py`, step 7)."""
    from tinyvc_tpu_torch.train import encoder_train as pet
    from tinyvc_tpu_torch.utils.weights import encoder_from_jax, load_npz

    d = tmp_path_factory.mktemp("enc")
    enc = encoder_from_jax(load_npz(os.path.join(MODELS, "encoder_B.npz"))).train()
    CheckpointManager(str(d)).save(7, pet.EncoderTrainState(enc, pdt.OptState.fresh(enc), 7))
    return str(d)


def test_encoder_directory_loads_as_its_npz(encoder_dir):
    from tinyvc_tpu_torch.train.loop import load_encoder
    from tinyvc_tpu_torch.utils.model_store import load_encoder_params

    cfg = pcfg.TinyVCConfig()
    a = load_encoder(encoder_dir, cfg, 0, "cpu")
    b = load_encoder(os.path.join(MODELS, "encoder_B.npz"), cfg, 0, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    tree = load_encoder_params(encoder_dir)["params"]
    want = np.load(os.path.join(MODELS, "encoder_B.npz"))
    name = "params/pitch_estimator/stack/layer_0/pw1/kernel"
    np.testing.assert_array_equal(tree["pitch_estimator"]["stack"]["layer_0"]["pw1"]["kernel"],
                                  want[name])


@pytest.fixture(scope="module")
def full_cache(tmp_path_factory):
    """Three 2 s chunks of the demo: the device-resident cache holds the
    config's chunk length."""
    d = tmp_path_factory.mktemp("full")
    wave = load_audio(os.path.join(ROOT, "demo", "two_speaker", "source_A.wav"))[0][0]
    for i in range(3):
        save_wav(str(d / f"{i}.wav"), wave[48000 * i: 48000 * (i + 1)])
        np.save(d / f"{i}.f0.npy", np.full(100, 150.0, np.float32))
    return str(d)


@pytest.mark.parametrize("k", ["1", "2"], ids=["per_step", "two_a_window"])
def test_cli_device_data_trains_logs_and_resumes(full_cache, encoder_dir, tmp_path, k):
    """``--device-data -K k`` from the encoder's checkpoint directory: two
    pre-join steps, logged and saved at step 2, then resumed to step 4."""
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    args = ["--dataset-cache", full_cache, "-encp", encoder_dir, "-decp", str(ckpt),
            "--init-decoder", os.path.join(MODELS, "decoder_B.npz"), "--log-dir", str(logs),
            "-b", "2", "--log-interval", "2", "--save-interval", "2", "-spec-type", "mel",
            "--device-data", "-K", k, "--device", "cpu"]
    for steps in ("2", "4"):
        proc = _run(args + ["-step", steps], tmp_path)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "device-resident dataset: 3 chunks" in proc.stdout
        assert ("multi-step dispatch: K=2 steps per device call" in proc.stdout) == (k == "2")
    assert "resumed decoder training at step 2" in proc.stdout
    lines = [json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [2, 4]
    assert all(np.isfinite(r["loss/Spectrogram"]) and np.isfinite(r["loss/DSP"]) for r in lines)
    assert CheckpointManager(str(ckpt)).steps() == [2, 4]
    saved = torch.load(ckpt / "4" / "state.pt", weights_only=False)
    assert saved["step"] == 4 and saved["gen_opt/count"] == 4
