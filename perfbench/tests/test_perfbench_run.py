"""Runs of every cell, and of the shelved backfill, at the tiny size on
the CPU (the harness's look for a card skipped), the faults that must make
``correct`` false, the control that must fail the comparison, and the
command's refusal without a card. The test marked ``cuda`` runs the
command itself on the card, for each cell of ``BENCHMARK.json``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import control, harness
from perfbench.drivers import common

from conftest import ROOT, tiny_benchmark, tiny_root

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


#: the faults a cell of these kinds can have, planted in the program's
#: factor step (``pipeline._stacked``, under every resident step and every
#: batch of the host driver)
FAULTS = {
    "step_writes_nothing": torch.zeros_like,
    "half_the_batch_left_out": half_left_out,
    "an_answer_altered": answer_altered,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(root, monkeypatch, cell, fault):
    from replication_of_minute_frequency_factor_tpu_torch import pipeline

    real = pipeline._stacked
    monkeypatch.setattr(pipeline, "_stacked",
                        lambda *a, **k: FAULTS[fault](real(*a, **k)))
    out = harness.run_cell(harness.resolve(cell, root), 2**31 + 12, 0.05,
                           False, device="cpu")
    assert not out["correct"]


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


YEAR_CELLS = [c for c in CELLS if c.endswith(".year_resident")]


@pytest.mark.parametrize("cell", YEAR_CELLS)
def test_a_year_with_its_later_steps_dropped_is_not_correct(root,
                                                            monkeypatch,
                                                            cell):
    from replication_of_minute_frequency_factor_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "compute_packed_resident",
                        later_steps_dropped(pipeline.compute_packed_resident))
    for seed in (2**31 + 14, 2**33 + 7):
        out = harness.run_cell(harness.resolve(cell, root), seed, 0.05,
                               False, device="cpu")
        assert not out["correct"]


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
