"""Every cell's tiny size, as its own files declare it: each mix a cell
uses has a ``tiny`` block, no block names a key its file lacks, and no
cell's tiny run computes more than ``MAX_TINY_BARS`` bars a pass."""

import json
import shutil

import pytest

from perfbench import harness

from conftest import (BENCH, MAX_TINY_BARS, ROOT, bars_a_pass, mix_path,
                      tiny_benchmark, tiny_problems, tiny_root)

CELLS = [w["name"] for w in tiny_benchmark()["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def test_every_cell_has_its_tiny_sizes():
    assert tiny_problems() == []


def test_the_guard_finds_a_missing_or_unknown_tiny_block(tmp_path):
    src = tmp_path / "src"
    (src / "perfbench").mkdir(parents=True)
    for sub in ("configs", "mixes"):
        shutil.copytree(BENCH / sub, src / "perfbench" / sub)
    shutil.copy(ROOT / "BENCHMARK.json", src / "BENCHMARK.json")
    assert tiny_problems(src) == []

    def edit(path, change):
        body = json.loads(path.read_text())
        change(body)
        path.write_text(json.dumps(body))

    edit(mix_path(src, "year_resident"), lambda m: m.pop("tiny"))
    edit(mix_path(src, "backfill_files"),
         lambda m: m["tiny"]["check"].update(nosuch=1))
    edit(src / "perfbench/configs/us_russell3000.json",
         lambda c: c.update(tiny={"tickers": 8, "days": 2}))
    problems = tiny_problems(src)
    assert problems == [
        "mix 'backfill_files': tiny names 'check.nosuch', which it lacks",
        "mix 'year_resident' has no tiny block",
        "configuration 'us_russell3000': tiny names 'days', which it lacks"]
    with pytest.raises(ValueError, match="no tiny size"):
        tiny_root(tmp_path / "tiny", src)


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_stays_small(root, cell):
    assert bars_a_pass(harness.resolve(cell, root)) <= MAX_TINY_BARS
