"""Runs of every cell, and of the shelved backfill, at the tiny size on
the CPU (the harness's look for a card skipped), the faults that must make
``correct`` false (in each cell, those its driver declares), a cell of a
new mix brought by its files alone, the control that must fail the
comparison, and the command's refusal without a card. The test marked
``cuda`` runs the command itself on the card, for each cell of
``BENCHMARK.json``."""

import importlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import control, harness
from perfbench.drivers import common

from conftest import (BENCH, MAX_TINY_BARS, ROOT, bars_a_pass,
                      cells_with_fault, mix_path, tiny_benchmark, tiny_root)

CELLS = [w["name"] for w in tiny_benchmark()["workloads"]]
ON_CARD = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(root, cell, trace):
    c = harness.resolve(cell, root)
    out = harness.run_cell(c, 2**31 + 11, 0.05, trace, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    want = c.per_layer if trace else c.end_to_end
    got = set(out["metrics"])
    # the CPU has no device events: the rolling kernel's share is silent
    assert got <= {m["name"] for m in want}
    if not trace:
        assert got == {m["name"] for m in want}
    check = out["checks"][common.CHECK]
    assert check["value"] <= check["limit"]
    line = json.loads(harness.result_line(out, {"platform": "cpu"}))
    assert list(line) [-1] == "checks"
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def half_left_out(y):
    """``[F, D, T]`` with the later half of the batch's days not computed
    (the tickers axis may be mostly padding at the tiny size)."""
    y = y.clone()
    y[:, y.shape[1] // 2:] = 0.0
    return y


def answer_altered(y):
    y = y.clone()
    y[0] = y[0] * 1.01 + 0.01
    return y


def in_the_step(fault):
    """``fault`` applied to what the program's factor step returns."""
    return lambda real: lambda *a, **k: fault(real(*a, **k))


def later_steps_dropped(real):
    """``compute_packed_resident`` running only the first half of the
    year's steps: the later half of its result is never written (zeros
    here, so that the fault reads alike on every run)."""
    def call(dbufs, *a, **k):
        dbufs = list(dbufs)
        done = real(dbufs[:len(dbufs) // 2], *a, **k)
        out = done.new_zeros((len(dbufs), *done.shape[1:]))
        out[:len(done)] = done
        return out
    return call


#: every fault a cell can have, by name: the program function it is
#: planted in (``pipeline.<name>``; ``_stacked`` is the factor step, under
#: every resident step and every batch of the host driver) and what it
#: makes of that function. Each driver's ``FAULTS`` names those that apply
#: to what it runs, and a cell is tested for its driver's.
PLANTED = {
    "step_writes_nothing": ("_stacked", in_the_step(torch.zeros_like)),
    "half_the_batch_left_out": ("_stacked", in_the_step(half_left_out)),
    "an_answer_altered": ("_stacked", in_the_step(answer_altered)),
    "later_steps_dropped": ("compute_packed_resident", later_steps_dropped),
}
STEP_FAULTS = sorted(f for f, (at, _) in PLANTED.items() if at == "_stacked")


def plant(monkeypatch, fault: str) -> None:
    from replication_of_minute_frequency_factor_tpu_torch import pipeline

    at, make = PLANTED[fault]
    monkeypatch.setattr(pipeline, at, make(getattr(pipeline, at)))


def test_each_driver_declares_faults_planted_here():
    mods = [importlib.import_module(f"perfbench.drivers.{p.stem}")
            for p in sorted((harness.BENCH_DIR / "drivers").glob("*.py"))]
    declared = {m.__name__: set(m.FAULTS) for m in mods
                if hasattr(m, "Driver")}
    assert declared and all(declared.values()), declared
    assert set().union(*declared.values()) == set(PLANTED), declared


@pytest.mark.parametrize("cell,fault", [
    pytest.param(cell, fault, id=f"{cell}-{fault}")
    for fault in STEP_FAULTS for cell in cells_with_fault(fault)])
def test_a_broken_step_is_not_correct(root, monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    out = harness.run_cell(harness.resolve(cell, root), 2**31 + 12, 0.05,
                           False, device="cpu")
    assert not out["correct"]


@pytest.mark.parametrize("cell", cells_with_fault("later_steps_dropped"))
def test_a_year_with_its_later_steps_dropped_is_not_correct(root,
                                                            monkeypatch,
                                                            cell):
    plant(monkeypatch, "later_steps_dropped")
    for seed in (2**31 + 14, 2**33 + 7):
        out = harness.run_cell(harness.resolve(cell, root), seed, 0.05,
                               False, device="cpu")
        assert not out["correct"]


def test_a_new_mix_joins_by_its_files_alone(tmp_path):
    """A cell whose mix is a new file (a new traffic name, the resident
    driver, its own ``tiny`` block) on a new configuration with its own
    ``tiny`` block: ``tiny_root`` shrinks both to their blocks, its
    driver's faults select it and make it not correct, and its tiny run
    is correct on the CPU."""
    src = tmp_path / "src"
    (src / "perfbench").mkdir(parents=True)
    for sub in ("configs", "mixes", "metrics"):
        shutil.copytree(BENCH / sub, src / "perfbench" / sub)
    full = json.loads(mix_path(ROOT, "year_resident").read_text())
    full.update(batches=4, days_per_batch=16)
    del full["tiny"]
    tiny_mix = {"batches": 2, "days_per_batch": 3, "trace_passes": 1,
                "check": {"batches": 2, "days_per_batch": 2, "tickers": 10}}
    mix_path(src, "year_fresh").write_text(json.dumps(
        dict(full, tiny=tiny_mix)))
    cfg = json.loads((BENCH / "configs/cn_ashare_5000.json").read_text())
    (src / "perfbench/configs/cn_fresh.json").write_text(json.dumps(
        dict(cfg, name="cn_fresh", tiny={"tickers": 16})))
    name = "cn_fresh.year_fresh"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cn_fresh", "source": "a test",
                             "file": "perfbench/configs/cn_fresh.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": "cn_fresh",
                               "traffic": "year_fresh", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cn_ashare_5000.year_resident" in m.get("workloads", []):
            m["workloads"].append(name)
    (src / "BENCHMARK.json").write_text(json.dumps(bench))

    root = tiny_root(tmp_path / "tiny", src)
    assert json.loads(mix_path(root, "year_fresh").read_text()) == {
        **full, **tiny_mix, "check": {**full["check"], **tiny_mix["check"]}}
    cell = harness.resolve(name, root)
    assert cell.config == dict(cfg, name="cn_fresh", tickers=16)
    assert bars_a_pass(cell) == 2 * 3 * 16 * 240 <= MAX_TINY_BARS

    faults = harness.driver_module(cell).FAULTS
    assert "later_steps_dropped" in faults
    assert all(name in cells_with_fault(f, src) for f in faults)
    out = harness.run_cell(cell, 2**31 + 15, 0.05, False, device="cpu")
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "resident_days_per_s"}
    for fault in faults:
        with pytest.MonkeyPatch.context() as mp:
            plant(mp, fault)
            out = harness.run_cell(cell, 2**31 + 15, 0.05, False,
                                   device="cpu")
        assert not out["correct"], fault


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_comparison(root, cell, monkeypatch):
    monkeypatch.setattr(harness, "ROOT", root)
    c = harness.resolve(cell, root)
    for seed in (1, 2**31 + 13, 2**33 + 5):
        got = control.control_reading(c, seed)[common.CHECK]
        assert got["value"] > got["limit"]


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert not any(l.startswith("{") for l in out.stdout.splitlines())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ON_CARD)
def test_the_command_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 21), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
