"""The plain reference against the port on the CPU, end to end through a
small run of each configuration with the shipped weights, and the
reference's own pieces against textbook forms."""

import numpy as np
import pytest
import torch

from vcbench import run
from vcbench.harness import judge
from vcbench.reference import model as ref

# On the CPU the port runs its kernels' plain versions. Kernel A's plain
# version accumulates the phase in fp32 and drifts from the float64 truth
# (~1e-4 over 2 s); the card's closed form does not, so the limit of
# ``harmonics`` holds there and this bound here.
CPU_HARMONICS = 1e-3


@pytest.mark.parametrize("name", ["convert-fp32-dict4k", "convert-serving-dict4k"])
def test_port_meets_the_limits_on_the_cpu(small_cell, name):
    cell = small_cell(name)
    result = run.run_cell(cell, 2**31 + 101, 1.0, False, "cpu")
    limits = cell.config["limits"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    for n, c in result["checks"].items():
        assert c["limit"] == limits[n]
        bound = CPU_HARMONICS if n == "harmonics" else limits[n]
        assert c["value"] <= bound, (n, c)


def test_spectrogram_is_the_windowed_dft():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 4 * 480)))
    spec = ref.spectrogram(x, 1920, 480)
    xp = np.pad(x[0].numpy(), 960, mode="reflect")
    n = np.arange(1920)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / 1920)
    frame = xp[480:480 + 1920] * win  # frame 1 (frame 0 is dropped)
    dft = np.abs(np.exp(-2j * np.pi * np.outer(np.arange(961), n) / 1920) @ frame)
    assert spec.shape == (1, 4, 961)
    np.testing.assert_allclose(spec[0, 0].numpy(), dft, rtol=1e-9, atol=1e-9)


def test_harmonics_follow_the_running_phase():
    f0 = torch.full((1, 4), 100.0, dtype=torch.float64)
    amps = torch.ones(1, 4, 3, dtype=torch.float64)
    h = ref.harmonics(f0, amps, 480, 24000, 20.0)
    t = np.arange(1, 4 * 480 + 1) / 24000.0  # the phase sums the first sample
    for k in range(3):
        np.testing.assert_allclose(h[0, k].numpy(), np.sin(2 * np.pi * 100.0 * (k + 1) * t),
                                   atol=1e-9)


def test_noise_is_the_istft_of_hashed_phases():
    kernel = torch.rand(2, 3, 961, dtype=torch.float64)
    n = ref.noise(kernel, 1234, 480, 1920)
    assert n.shape == (2, 3 * 480)
    # rows keep their hash counter when judged in blocks
    np.testing.assert_array_equal(ref.noise(kernel[1:], 1234, 480, 1920, row0=1).numpy(),
                                  n[1:].numpy())


def test_control_rounding():
    # TF32 keeps 10 mantissa bits: ties away from zero, the rest to the nearest
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-12], dtype=torch.float64)
    assert ref.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0]
    # fp8 e4m3 keeps 3: at most half a step, 2**-4 of the value, off
    y = torch.linspace(-2.0, 2.0, 101, dtype=torch.float64)
    q = ref.fp8_round(y)
    assert bool(((q - y).abs() <= y.abs() * 2**-4 + 1e-12).all())


def test_gaps_accept_near_ties_and_refuse_other_answers():
    enc = {"pitch_topk": 4, "min_frequency": 20.0, "classes_per_octave": 48}
    logits = torch.zeros(1, 2, 512, dtype=torch.float64)
    logits[0, :, 200:206] = torch.tensor([5.0, 4.0, 3.0, 2.0, 2.0 - 1e-9, 1.0], dtype=torch.float64)
    vals, ids = torch.topk(logits, 4, dim=-1)
    f0 = ref.shift_pitch(ref.f0_of(vals, ids, enc), 0.0)
    assert judge.f0_gap(f0, logits, 0.0, enc) == 0.0
    swapped = ids.clone()
    swapped[..., 3] = 204  # the near tie taken the other way
    f0s = ref.shift_pitch(ref.f0_of(vals, swapped, enc), 0.0)
    assert 0.0 < judge.f0_gap(f0s, logits, 0.0, enc) < 1e-8
    assert judge.f0_gap(f0 * 1.01, logits, 0.0, enc) == judge.NO_MATCH
    d = torch.eye(8, dtype=torch.float64)[:, :6] + 0.01
    content = d[:1][None] + 0.001  # nearest rows: 0, then the rest alike
    matched = ref.match(content, d, 4)
    assert judge.match_numbers(matched, content, d, 4) == (0.0, 0.0)
    assert judge.match_numbers(matched + 0.5, content, d, 4)[1] >= 0.49  # 0.5 / 1.01
    # rows rounded as kernel H rounds them: the same rows, a bf16-sized error
    rounded = ref.match(content, d, 4, ref.Precision(low=lambda x: x.bfloat16().double()))
    gap, err = judge.match_numbers(rounded, content, d, 4)
    assert gap == 0.0 and 0.0 < err <= 2**-8
