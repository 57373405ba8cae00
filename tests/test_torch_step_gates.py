"""Gate C of `chip_smoke.py`'s fp32 step checks, on synthetic leaves.

`chip_smoke._gate_c` decides the gate from plain dicts of floats: each
source's distance per leaf (kernel path against plain path) and each
source's floor per leaf (the plain path against itself, that source moved a
little more). A leaf's median distance over the sources is held to
max(STEP_GRAD_RTOL, STEP_FLOOR_FACTOR x its median floor over the same
sources), and the median over sources of each source's median leaf to
STEP_GRAD_RTOL. No card is needed."""

import pytest

import chip_smoke

SOURCES = 1 + chip_smoke.STEP_DRAWS
QUIET = {f"leaf_{i}": 1e-4 for i in range(9)}  # keeps the median of medians low


def _sources(leaf: str, values, quiet=QUIET):
    """One dict a source: ``leaf`` at its value there, beside the quiet leaves."""
    return [dict(quiet, **{leaf: v}) for v in values]


# (distances over the five sources, floors over them, the quiet leaves'
# distance and floor, whether the gate passes)
CASES = {
    # the closed-form A's pattern (PERF.md §6): a flip-sized distance
    # on every source, the shipped source's floor low, most floors flipped
    "one_low_floor_passes": ([4.8e-3, 4.83e-3, 4.75e-3, 4.8e-3, 4.82e-3],
                             [3.5e-4, 4.83e-3, 9.5e-4, 4.8e-3, 4.8e-3], 1e-4, 0.0, True),
    "leaf_over_low_floors_fails": ([5e-3] * 5, [1e-4] * 5, 1e-4, 1e-4, False),
    # every leaf within its limit (floors of 1), the median of medians 2e-3
    "median_of_medians_fails": ([2e-3] * 5, [1.0] * 5, 2e-3, 1.0, False),
    "under_rtol_passes_with_zero_floors": ([9e-4] * 5, [0.0] * 5, 1e-4, 0.0, True),
}


@pytest.mark.parametrize("reorder", [False, True], ids=["in_order", "sources_reordered"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_c(case, reorder):
    dists, floors, quiet_dist, quiet_floor, passes = CASES[case]
    assert len(dists) == len(floors) == SOURCES
    per_draw = _sources("x", dists, {k: quiet_dist for k in QUIET})
    floor_dicts = _sources("x", floors, {k: quiet_floor for k in QUIET})
    med, leaves, failures = chip_smoke._gate_c(per_draw, floor_dicts)
    if reorder:  # the same sources in another order: the same decision, the same numbers
        order = [3, 0, 4, 2, 1]
        again = chip_smoke._gate_c([per_draw[i] for i in order], [floor_dicts[i] for i in order])
        assert again == (med, leaves, failures)
    assert (not failures) == passes, failures
    m, limit = leaves["x"]
    assert m == sorted(dists)[SOURCES // 2]
    want_limit = max(chip_smoke.STEP_GRAD_RTOL,
                     chip_smoke.STEP_FLOOR_FACTOR * sorted(floors)[SOURCES // 2])
    assert limit == want_limit
    if case == "median_of_medians_fails":
        assert med > chip_smoke.STEP_GRAD_RTOL
        assert all(m <= lim for m, lim in leaves.values())  # only the median fails
        assert len(failures) == 1 and failures[0].startswith("gate C: median")
    if case == "one_low_floor_passes":  # the shipped source's floor alone would fail it
        assert m > max(chip_smoke.STEP_GRAD_RTOL, chip_smoke.STEP_FLOOR_FACTOR * floors[0])
        assert limit == pytest.approx(9.6e-3)
    if case == "leaf_over_low_floors_fails":
        assert failures == [f"gate C: x {5e-3:.3e} > {chip_smoke.STEP_GRAD_RTOL:.3e}"]

