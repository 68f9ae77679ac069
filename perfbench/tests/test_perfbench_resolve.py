"""``BENCHMARK.json`` against the benchmark's contract, every name it
gives resolved to its files, and a cell, configuration, mix and metric
registered from a temporary directory by files and entries alone."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

from conftest import ROOT, tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert all(line(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["perfbench"]
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fit_the_check_at_24_cells():
    full = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert full <= 43200


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("perfbench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert body["precision"] == "float32"
        assert body["factors"] == 58


def test_workloads():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        mover = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in CELLS
            assert "workloads" not in mover or w in mover["workloads"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports_enough(cell):
    c = harness.resolve(cell)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and set(c.readers) == {m["name"]
                                              for m in c.per_layer}
    assert (harness.BENCH_DIR / "drivers"
            / f"{c.mix['driver']}.py").is_file()
    assert c.config["name"] == c.workload["config"]


def test_a_missing_name_is_refused(tmp_path):
    root = tiny_root(tmp_path)
    with pytest.raises(harness.CellError):
        harness.resolve("nosuch.cell", root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][0]["traffic"] = "nosuch_mix"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(harness.CellError):
        harness.resolve(bench["workloads"][0]["name"], root)


def test_register_a_cell_config_mix_and_metric_from_files(tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell as
    new files and entries; the harness finds and runs them unchanged."""
    root = tiny_root(tmp_path)
    cfg = json.loads((root / "perfbench/configs/cn_ashare_5000.json")
                     .read_text())
    (root / "perfbench/configs/cn_small.json").write_text(json.dumps(
        dict(cfg, name="cn_small", tickers=16)))
    mix = json.loads((root / "perfbench/mixes/year_resident.json")
                     .read_text())
    (root / "perfbench/mixes/year_short.json").write_text(json.dumps(
        dict(mix, batches=1)))
    (root / "perfbench/metrics/days_traced.py").write_text(
        "def read(run):\n    return float(run.counters['days_traced'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cn_small", "source": "a test",
                             "file": "perfbench/configs/cn_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "cn_small.year_short",
                               "config": "cn_small",
                               "traffic": "year_short", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("cn_small.year_short")
    bench["per_layer"].append({"name": "days_traced", "unit": "days",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "resident loop",
                               "moves": "resident_days_per_s",
                               "workloads": ["cn_small.year_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve("cn_small.year_short", root)
    assert cell.config["tickers"] == 16 and cell.mix["batches"] == 1
    out = harness.run_cell(cell, 5, 0.1, True, device="cpu")
    assert out["correct"]
    assert out["metrics"]["days_traced"]["value"] == 2.0


def test_family_reader_serves_a_dotted_name(tmp_path):
    p = harness.reader_path(harness.BENCH_DIR, "device_idle_pct.anything")
    assert p.name == "device_idle_pct.py"
    with pytest.raises(harness.CellError):
        harness.reader_path(Path(tmp_path), "device_idle_pct.resident")
