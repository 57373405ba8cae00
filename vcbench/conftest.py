"""Test settings of the benchmark's own tests (`python -m pytest vcbench`)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; decides inside the test and skips without one")


import pytest  # noqa: E402

SMALL_TRAFFIC = dict(batch=3, lengths_per_cycle=3, seconds_min=1.0, seconds_max=2.0,
                     dictionary={"utterances": 2, "frames": 128}, trace_requests=4,
                     check_requests=2)


@pytest.fixture
def small_cell():
    """A cell of `BENCHMARK.json` cut to a CPU test's size: 3 rows of 1-2 s
    a request, a 256-row dictionary, the fused U-Net's plain versions."""
    from vcbench.harness import cells

    def make(name: str):
        cell = cells.resolve(name)
        cell.config["decoder"]["use_fused_filter"] = "on"
        cell.traffic.update(SMALL_TRAFFIC)
        return cell

    return make
