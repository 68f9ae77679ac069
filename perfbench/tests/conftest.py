"""Fixtures of the benchmark's tests: a checkout-like root in a temporary
directory whose cells are the real ones at a size the CPU holds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the tiny sizes: the year as 2 batches of 2 days, the backfill as 4
#: day files 2 a batch, 24 tickers, a few lanes checked
TINY_CONFIG = {"tickers": 24}
TINY_MIX = {
    "year_resident": {"batches": 2, "days_per_batch": 2, "trace_passes": 1,
                      "check": {"batches": 2, "days_per_batch": 1,
                                "tickers": 12}},
    "backfill_files": {"days": 4, "days_per_batch": 2,
                       "trace_passes": 1,
                       "check": {"days": 2, "tickers": 12}},
}


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


def tiny_benchmark() -> dict:
    """``BENCHMARK.json`` with the shelved cell and its metrics added."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in SHELVED.items():
        bench[key] = bench[key] + entries
    return bench


def tiny_root(tmp: Path) -> Path:
    """``tmp`` laid out as a checkout holding the benchmark's cells and the
    shelved one at the tiny sizes: its own ``BENCHMARK.json``,
    configurations, mixes and metric readers."""
    bench = tiny_benchmark()
    (tmp / "perfbench").mkdir(parents=True)
    for sub in ("configs", "mixes", "metrics"):
        shutil.copytree(BENCH / sub, tmp / "perfbench" / sub)
    for c in bench["configs"]:
        p = tmp / c["file"]
        p.write_text(json.dumps(dict(json.loads(p.read_text()),
                                     **TINY_CONFIG)))
    for name, kw in TINY_MIX.items():
        p = tmp / "perfbench" / "mixes" / f"{name}.json"
        mix = json.loads(p.read_text())
        mix.update({k: v for k, v in kw.items() if k != "check"})
        mix["check"].update(kw["check"])
        p.write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
