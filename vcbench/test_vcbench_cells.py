"""The benchmark is driven by data: every cell resolves to its files, and a
new cell, configuration, traffic mix or per-layer metric is files and
entries only."""

import json
import os
import re
import shutil

import pytest

from vcbench.harness import cells, counts, trace

ROOT = cells.ROOT
BENCH = cells.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = cells.resolve(name)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"audio_s_per_s", "request_p95_ms", "setup_s"}
    assert cell.config["weights"] and cell.traffic["batch"] > 0
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))


def test_benchmark_file_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vcbench"] and BENCH["command"][1] == "vcbench/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vcbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A copy of the benchmark gains a traffic mix, a per-layer metric and a
    cell by new files and new entries; the harness finds them by name."""
    shutil.copytree(os.path.join(ROOT, "vcbench"), tmp_path / "vcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    mix = cells.load_json(os.path.join(ROOT, "vcbench", "traffic", "batch16-dict4k.json"))
    mix["batch"] = 4
    (tmp_path / "vcbench" / "traffic" / "batch4-dict4k.json").write_text(json.dumps(mix))
    (tmp_path / "vcbench" / "metrics" / "busy_ms.py").write_text(
        "def read(trace):\n    return 1e3 * trace.busy_s()\n")
    bench["workloads"].append({"name": "convert-fp32-b4", "config": "tinyvc-fp32",
                               "traffic": "batch4-dict4k", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "busy_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "audio_s_per_s", "workloads": ["convert-fp32-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.resolve("convert-fp32-b4", str(tmp_path))
    assert cell.traffic["batch"] == 4 and [m["name"] for m in cell.per_layer] == ["busy_ms"]
    events = [dict(cat="user_annotation", name="request", ts=0.0, dur=1.0, corr=None),
              dict(cat="kernel", name="k", ts=0.25, dur=0.5, corr=1)]
    t = trace.Trace(events, [(4, 61440)], 4096, cell.config)
    assert cells.metric_reader("busy_ms", str(tmp_path))(t) == pytest.approx(500.0)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve("no-such-cell")


def test_configs_hold_the_published_widths():
    """`reduced` is empty: every width is TinyVCConfig()'s."""
    for c in BENCH["configs"]:
        cfg = cells.load_json(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
        assert cfg["encoder"]["ssl_dim"] == 768 and cfg["encoder"]["ssl_channels"] == 384
        assert cfg["decoder"]["filter_channels"] == [384, 192, 96, 48, 24]
        assert counts.PEAKS[cfg["decoder"]["compute_dtype"]] > 0
