"""Fixtures of the benchmark's tests: a checkout-like root in a temporary
directory whose cells are the real ones at a size the CPU holds.

Each file declares its own tiny size: a mix (``mixes/<traffic>.json``) by
its ``tiny`` block, which every mix a cell uses has, and a configuration
by its ``tiny`` block or, without one, :data:`DEFAULT_TINY_CONFIG`. A
block's values replace the file's; a group (``check``) is merged key by
key. Drivers and the harness never read ``tiny``: a full-size run is the
file without it. So a new cell, configuration or mix brings its tiny size
in its own files, and nothing here changes."""

import importlib
import json
import shutil
import sys
from pathlib import Path
from typing import List

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a configuration's tiny size when its file has no ``tiny`` block
DEFAULT_TINY_CONFIG = {"tickers": 24}
#: the most bars a cell's tiny run may compute a pass
MAX_TINY_BARS = 200_000


#: the file backfill, held out of ``BENCHMARK.json`` until its runs agree
#: (PERF.md, open questions): its driver, mix and readers stay, and these
#: entries bring it back as they are
SHELVED = {
    "workloads": [
        {"name": "cn_ashare_5000.backfill_files", "config": "cn_ashare_5000",
         "traffic": "backfill_files", "chips": 1,
         "why": "40 parquet day files x 5000 tickers from an empty cache"}],
    "end_to_end": [
        {"name": "backfill_days_per_s", "unit": "days/s", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["cn_ashare_5000.backfill_files"]}],
    "per_layer": [
        {"name": "device_idle_pct.backfill", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "backfill_days_per_s",
         "workloads": ["cn_ashare_5000.backfill_files"]},
        {"name": "producer_ms_per_day.backfill", "unit": "ms/day",
         "better": "lower", "source": "program_span",
         "layer": "host driver: producer", "moves": "backfill_days_per_s",
         "workloads": ["cn_ashare_5000.backfill_files"]}],
}


def tiny_benchmark(src: Path = ROOT) -> dict:
    """``src``'s ``BENCHMARK.json`` with the shelved cell and its metrics
    added."""
    bench = json.loads((Path(src) / "BENCHMARK.json").read_text())
    for key, entries in SHELVED.items():
        bench[key] = bench[key] + entries
    return bench


def shrunk(full: dict, tiny: dict) -> dict:
    """``full`` with ``tiny``'s values, a group merged key by key."""
    out = dict(full)
    for k, v in tiny.items():
        out[k] = shrunk(full[k], v) if isinstance(v, dict) else v
    return out


def unknown_keys(full: dict, tiny: dict, at: str = "") -> List[str]:
    """The keys of ``tiny`` (dotted within a group) that ``full`` lacks or
    holds as another kind of value."""
    bad = []
    for k, v in tiny.items():
        if k not in full or isinstance(v, dict) != isinstance(full[k], dict):
            bad.append(at + k)
        elif isinstance(v, dict):
            bad += unknown_keys(full[k], v, f"{at}{k}.")
    return bad


def mix_path(src: Path, traffic: str) -> Path:
    return Path(src) / "perfbench" / "mixes" / f"{traffic}.json"


def tiny_problems(src: Path = ROOT) -> List[str]:
    """What keeps a cell of ``src`` (``BENCHMARK.json`` and the shelved
    one) from its tiny size: a mix without a ``tiny`` block, or a block of
    a mix or a configuration naming a key that the file does not have."""
    bench, src = tiny_benchmark(src), Path(src)
    problems = []
    for traffic in sorted({w["traffic"] for w in bench["workloads"]}):
        mix = json.loads(mix_path(src, traffic).read_text())
        if not isinstance(mix.get("tiny"), dict):
            problems.append(f"mix {traffic!r} has no tiny block")
            continue
        problems += [f"mix {traffic!r}: tiny names {k!r}, which it lacks"
                     for k in unknown_keys(mix, mix["tiny"])]
    for c in bench["configs"]:
        cfg = json.loads((src / c["file"]).read_text())
        problems += [f"configuration {c['name']!r}: tiny names {k!r}, "
                     "which it lacks"
                     for k in unknown_keys(cfg, cfg.get("tiny", {}))]
    return problems


def tiny_root(tmp: Path, src: Path = ROOT) -> Path:
    """``tmp`` laid out as a checkout holding ``src``'s cells and the
    shelved one at the tiny sizes: its own ``BENCHMARK.json``,
    configurations, mixes and metric readers, each configuration and each
    mix a cell uses shrunk by its own ``tiny`` block (and without it)."""
    bench, src = tiny_benchmark(src), Path(src)
    problems = tiny_problems(src)
    if problems:
        raise ValueError("no tiny size: " + "; ".join(problems))
    (tmp / "perfbench").mkdir(parents=True)
    for sub in ("configs", "mixes", "metrics"):
        shutil.copytree(src / "perfbench" / sub, tmp / "perfbench" / sub)
    for c in bench["configs"]:
        p = tmp / c["file"]
        cfg = json.loads(p.read_text())
        p.write_text(json.dumps(shrunk(
            cfg, cfg.pop("tiny", DEFAULT_TINY_CONFIG))))
    for traffic in {w["traffic"] for w in bench["workloads"]}:
        p = mix_path(tmp, traffic)
        mix = json.loads(p.read_text())
        p.write_text(json.dumps(shrunk(mix, mix.pop("tiny"))))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def bars_a_pass(cell) -> int:
    """The bars a pass of ``cell`` computes on the CPU: its days a pass
    (the driver's ``attempted`` after one pass past set-up) x its tickers
    x its session's slots."""
    from perfbench import harness
    from perfbench.reference import sessions

    state = harness.driver_module(cell).Driver(cell, 2**31 + 31, "cpu")
    try:
        state.run_pass()
        days = state.attempted
    finally:
        state.close()
    return (days * int(cell.config["tickers"])
            * sessions.from_config(cell.config["session"]).n_slots)


def driver_of(workload: dict, src: Path = ROOT):
    """The driver module that a workload's mix names."""
    mix = json.loads(mix_path(src, workload["traffic"]).read_text())
    return importlib.import_module(f"perfbench.drivers.{mix['driver']}")


def cells_with_fault(fault: str, src: Path = ROOT) -> List[str]:
    """The cells of ``src`` (and the shelved one) whose driver declares
    ``fault`` among its ``FAULTS``."""
    return [w["name"] for w in tiny_benchmark(src)["workloads"]
            if fault in driver_of(w, src).FAULTS]


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
