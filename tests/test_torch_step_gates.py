"""Gate C of `chip_smoke.py`'s fp32 step checks, on synthetic leaves.

`chip_smoke._gate_c` decides the gate from plain dicts of floats: each
source's distance per leaf (kernel path against plain path) and each
source's floor per leaf (the plain path against itself, that source moved a
little more). A leaf's median distance over the sources is held to
max(STEP_GRAD_RTOL, STEP_FLOOR_FACTOR x its median floor over the same
sources), and the median over sources of each source's median leaf (`med`)
to max(STEP_GRAD_RTOL, STEP_FLOOR_FACTOR x the same statistic of the floors,
`fmed`). No card is needed."""

import statistics

import pytest

import chip_smoke

SOURCES = 1 + chip_smoke.STEP_DRAWS
QUIET = [f"leaf_{i}" for i in range(9)]  # beside leaf "x": ten leaves a source


def _one_leaf(dists, floors, quiet_dist, quiet_floor):
    """Leaf "x" at its value on each source, the quiet leaves at one value."""
    return ([dict({k: quiet_dist for k in QUIET}, x=d) for d in dists],
            [dict({k: quiet_floor for k in QUIET}, x=f) for f in floors])


def _uniform(dists, floors):
    """Every leaf of source i at dists[i], every floor at floors[i]."""
    return ([{k: d for k in ["x", *QUIET]} for d in dists],
            [{k: f for k in ["x", *QUIET]} for f in floors])


def _leaves_high_sources_low(dist, high_floor, low_floor):
    """Six leaves at ``dist`` on every source, each with ``high_floor`` on
    three of the five sources (so each leaf's median floor is high) but no
    source with more than four high floors (so each source's median floor,
    over its ten leaves, is ``low_floor``); the other leaves at 0."""
    leaves = ["x", *QUIET]
    per_draw = [{k: (dist if j < 6 else 0.0) for j, k in enumerate(leaves)}
                for _ in range(SOURCES)]
    floors = [{k: low_floor for k in leaves} for _ in range(SOURCES)]
    for j in range(6):
        for s in range(3):
            floors[(3 * j + s) % SOURCES][leaves[j]] = high_floor
    return per_draw, floors


# The closed-form A's readings on the H100 (ROADMAP.md §3): each
# source's median leaf, kernel path against plain path, and the plain path
# against itself on the same sources
CLOSED_FORM_MEDIANS = [3.66e-3, 5.17e-4, 3.48e-3, 1.10e-3, 2.94e-4]
CLOSED_FORM_FLOORS = [3.65e-3, 5.00e-4, 3.61e-3, 1.13e-3, 5.24e-4]
# a pattern of floors like the H100's: flips on some sources, quiet leaves
PLAIN_FLOORS = [
    dict({k: 10.0 ** -(3.2 + 0.1 * j + 0.05 * s) for j, k in enumerate(QUIET)},
         x=[4.8e-3, 4.75e-3, 4.8e-3, 1.76e-4, 4.79e-3][s])
    for s in range(SOURCES)]

# name -> (per_draw, floors, whether the gate passes)
CASES = {
    # the closed-form A's pattern (ROADMAP.md §3): a flip-sized distance
    # on every source, the shipped source's floor low, most floors flipped
    "one_low_floor_passes": (*_one_leaf([4.8e-3, 4.83e-3, 4.75e-3, 4.8e-3, 4.82e-3],
                                        [3.5e-4, 4.83e-3, 9.5e-4, 4.8e-3, 4.8e-3], 1e-4, 0.0),
                             True),
    "leaf_over_low_floors_fails": (*_one_leaf([5e-3] * 5, [1e-4] * 5, 1e-4, 1e-4), False),
    # every leaf within its limit, the median of medians 2e-3 over floors
    # whose median of medians is 4e-4: the limit 1e-3
    "median_of_medians_fails": (*_leaves_high_sources_low(2e-3, 1.5e-3, 4e-4), False),
    "under_rtol_passes_with_zero_floors": (*_one_leaf([9e-4] * 5, [0.0] * 5, 1e-4, 0.0), True),
    # the closed-form A's sources: med 1.10e-3 against 2 x fmed 1.13e-3
    "closed_form_readings_pass": (*_uniform(CLOSED_FORM_MEDIANS, CLOSED_FORM_FLOORS), True),
    # the plain path against itself: distances equal to the floors
    "plain_against_itself_passes": ([dict(f) for f in PLAIN_FLOORS], PLAIN_FLOORS, True),
    "plain_against_itself_at_closed_form_floors_passes": (
        *_uniform(CLOSED_FORM_FLOORS, CLOSED_FORM_FLOORS), True),
    # med 2.5e-3 over floors whose median of medians is 1e-4
    "median_over_low_floor_medians_fails": (*_leaves_high_sources_low(2.5e-3, 1.5e-3, 1e-4),
                                            False),
}


@pytest.mark.parametrize("reorder", [False, True], ids=["in_order", "sources_reordered"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_c(case, reorder):
    per_draw, floors, passes = CASES[case]
    assert len(per_draw) == len(floors) == SOURCES
    got = chip_smoke._gate_c(per_draw, floors)
    med, fmed, med_limit, leaves, failures = got
    if reorder:  # the same sources in another order: the same decision, the same numbers
        order = [3, 0, 4, 2, 1]
        assert chip_smoke._gate_c([per_draw[i] for i in order],
                                  [floors[i] for i in order]) == got
    assert (not failures) == passes, failures
    # both statistics and the limit, as the gate defines them
    assert med == statistics.median(statistics.median(e.values()) for e in per_draw)
    assert fmed == statistics.median(statistics.median(f.values()) for f in floors)
    assert med_limit == max(chip_smoke.STEP_GRAD_RTOL, chip_smoke.STEP_FLOOR_FACTOR * fmed)
    for k, (m, limit) in leaves.items():
        assert m == sorted(e[k] for e in per_draw)[SOURCES // 2]
        assert limit == max(chip_smoke.STEP_GRAD_RTOL, chip_smoke.STEP_FLOOR_FACTOR
                            * sorted(f[k] for f in floors)[SOURCES // 2])
    median_failed = [f for f in failures if f.startswith("gate C: median")]
    assert bool(median_failed) == (med > med_limit)
    m, limit = leaves["x"]
    if case in ("median_of_medians_fails", "median_over_low_floor_medians_fails"):
        assert all(m <= lim for m, lim in leaves.values())  # only the median fails
        assert med_limit == chip_smoke.STEP_GRAD_RTOL
        assert failures == [f"gate C: median {med:.3e} > {med_limit:.3e}"]
        assert med == (2e-3 if case == "median_of_medians_fails" else 2.5e-3)
        assert fmed == (4e-4 if case == "median_of_medians_fails" else 1e-4)
    if case == "closed_form_readings_pass":  # over the fixed 1e-3, within 2 x fmed
        assert med == 1.10e-3 and fmed == 1.13e-3
        assert med > chip_smoke.STEP_GRAD_RTOL
        assert med_limit == pytest.approx(2.26e-3)
    if case.startswith("plain_against_itself"):
        assert med == fmed
    if case == "one_low_floor_passes":  # the shipped source's floor alone would fail it
        assert m > max(chip_smoke.STEP_GRAD_RTOL, chip_smoke.STEP_FLOOR_FACTOR * floors[0]["x"])
        assert limit == pytest.approx(9.6e-3)
    if case == "leaf_over_low_floors_fails":
        assert failures == [f"gate C: x {5e-3:.3e} > {chip_smoke.STEP_GRAD_RTOL:.3e}"]
