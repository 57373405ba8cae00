"""The comparison fails what it must: the control (the reference computed
in the precision just below the configuration's) and a run whose timed path
is broken underneath. On the CPU at a test's size; the control at the
cells' own size on the card (``-m chip``)."""

import numpy as np
import pytest
import torch

from vcbench import calibrate, run
from vcbench.harness import cells, judge

CELLS = ["convert-fp32-dict4k", "convert-serving-dict4k", "convert-serving-dict24k"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(small_cell, name):
    cell = small_cell(name)
    numbers = calibrate.control_numbers(cell, 2**31 + 3, "cpu")
    assert not judge.verdict(numbers, cell.config["limits"])
    failed = [n for n in numbers if numbers[n] > cell.config["limits"][n]]
    assert {"content", "amps", "noise_kernel", "harmonics", "noise", "out"} <= set(failed)


def _broken(monkeypatch, fault: str):
    """Break the timed path underneath ``VoiceConverter.convert``."""
    from tinyvc_tpu_torch.infer import generator

    decode, match = generator.decode_infer, generator.serving_match_features

    def decode_infer(*args, **kwargs):
        out = decode(*args, **kwargs)
        if fault == "half_batch":  # the second half of the rows left out
            out = out.clone()
            out[out.shape[0] // 2:] = 0.0
        elif fault == "altered_answer":  # 20 ms of one converted utterance altered
            out = out.clone()
            at = out.shape[1] // 3
            out[0, at:at + 480] += 0.25
        return out

    def serving_match_features(content, target, cfg):
        m = match(content, target, cfg)
        if fault == "altered_frame":  # one matched frame replaced by another's
            m = m.clone()
            m[0, 5] = m[0, 40]
        return m

    monkeypatch.setattr(generator, "decode_infer", decode_infer)
    monkeypatch.setattr(generator, "serving_match_features", serving_match_features)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault,number", [("half_batch", "out"), ("altered_answer", "out"),
                                          ("altered_frame", "match_err")])
def test_a_broken_timed_path_is_not_correct(small_cell, monkeypatch, name, fault, number):
    cell = small_cell(name)
    _broken(monkeypatch, fault)
    result = run.run_cell(cell, 2**31 + 17, 0.5, False, "cpu")
    assert result["correct"] is False
    c = result["checks"][number]
    assert c["value"] > c["limit"], (fault, result["checks"])


def test_an_unbroken_small_run_is_correct(small_cell):
    cell = small_cell("convert-fp32-dict4k")
    cell.config["limits"] = dict(cell.config["limits"], harmonics=1e-3)  # kernel A's plain version
    assert run.run_cell(cell, 2**31 + 17, 0.5, False, "cpu")["correct"] is True


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card_at_the_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control at the cell's own size")
    cell = cells.resolve(name)
    for k in range(3):
        numbers = calibrate.control_numbers(cell, 3_000_000_019 + 104729 * k, "cuda")
        assert not judge.verdict(numbers, cell.config["limits"]), numbers
    assert np.isfinite(list(numbers.values())).all()
