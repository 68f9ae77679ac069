"""The port's fuzz harnesses (its ``fuzz`` subpackage) on the CPU.

* every harness runs clean over a 3-seed window through the command
  line (``--device cpu``; refdiff on the stand-in reference tree) and
  prints its summary line, and ``--all`` runs every one;
* no harness is vacuous: each fails when the function it fuzzes is
  distorted;
* ``--device`` defaults to the card and raises without one;
* the rolling harness's vectorised f64 oracle is the per-window one of
  both packages, and its cases sweep the slot counts and windows the
  kernels branch on;
* ``chip_smoke.py`` reads its tolerance tables from the comparator copy.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu_torch import fuzz
from replication_of_minute_frequency_factor_tpu_torch.fuzz import (
    __main__ as cli, rolling as frolling, scenarios)

REPO = Path(__file__).resolve().parent.parent
STAND_IN = str(REPO / "tests" / "fixtures" / "refdiff_torch")

#: each harness's clean window: the historical tier, and for the harnesses
#: whose wider tiers start at 10k a window across the boundary
WINDOWS = {name: (0, 3) for name in fuzz.HARNESSES}
WINDOWS.update(pipeline=(9_999, 10_002), l3=(9_999, 10_002),
               group=(9_999, 10_002), parity=(30_999, 31_002))


def _cli(capsys, argv):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("name", fuzz.HARNESSES)
def test_harness_runs_clean_on_three_seeds(capsys, name):
    lo, hi = WINDOWS[name]
    argv = [name, str(lo), str(hi), "--device", "cpu"]
    if name == "refdiff":
        argv += ["--tree", STAND_IN]
    rc, out = _cli(capsys, argv)
    assert rc == 0, out
    assert "DONE 3 seeds, 0 failures: []" in out.splitlines()


def test_all_runs_every_harness(capsys):
    rc, out = _cli(capsys, ["--all", "0", "3", "--device", "cpu"])
    assert rc == 0, out
    lines = out.splitlines()
    assert lines[-1] == (f"DONE {len(fuzz.HARNESSES)} harnesses x [0, 3), "
                         "0 failures: []")
    for name in fuzz.HARNESSES:
        assert f"== {name} [0, 3) on cpu" in lines
    # no reference tree here: refdiff says so and checks nothing
    assert any(ln.startswith("refdiff: SKIPPED") for ln in lines)


def test_jobs_split_the_window_over_processes(capsys):
    rc, out = _cli(capsys, ["wire", "0", "6", "--device", "cpu",
                            "--jobs", "2"])
    assert rc == 0, out
    assert out.splitlines()[-2] == "DONE 6 seeds, 0 failures: []"


@pytest.mark.parametrize("argv", [
    ["parity", "0", "1"],
    ["--all", "0", "1"],
    ["rolling", "0", "1", "--device", "cuda"],
])
def test_device_defaults_to_the_card_and_raises_without_one(monkeypatch,
                                                             argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


@pytest.mark.parametrize("name", fuzz.HARNESSES)
def test_each_harness_run_asks_for_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fuzz.harness(name).run(0, 1)


@pytest.mark.parametrize("argv", [["parity", "0"], ["nope", "0", "1"],
                                  ["--all", "parity", "0", "1"],
                                  ["parity", "a", "b"]])
def test_bad_command_lines_exit_2(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2


def test_importing_the_harnesses_runs_nothing(capsys):
    import importlib

    for name in fuzz.HARNESSES + ("scenarios", "comparator", "__main__"):
        importlib.reload(importlib.import_module(f"{fuzz.__name__}.{name}"))
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# no harness is vacuous
# ---------------------------------------------------------------------------

def _scale(fn, k):
    return lambda *a, **kw: fn(*a, **kw) * k


def _distort_parity(mp):
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        registry)
    orig = registry.resolve("vol_return1min")
    mp.setitem(registry.FACTORS, "vol_return1min",
               lambda ctx: orig(ctx) * 1.01)


def _distort_rolling(mp):
    from replication_of_minute_frequency_factor_tpu_torch.ops import rolling
    real = rolling._second_moments_conv

    def off(xc, yc, mu_x, mu_y, w):
        s_xx, s_yy, s_xy = real(xc, yc, mu_x, mu_y, w)
        return s_xx, s_yy * 1.01, s_xy
    mp.setattr(rolling, "_second_moments_conv", off)


def _distort_wire(mp):
    from replication_of_minute_frequency_factor_tpu_torch.data import wire
    real = wire.decode

    def off(*a):
        bars, mask = real(*a)
        return bars * (1 + 1e-6), mask
    mp.setattr(wire, "decode", off)


def _distort_grid(mp):
    from replication_of_minute_frequency_factor_tpu_torch import native
    real = native.grid_pack_native

    def off(*a, **kw):
        bars, mask = real(*a, **kw)
        bars[..., 0, 3] += 0.01
        return bars, mask
    mp.setattr(native, "grid_pack_native", off)


def _distort_eval(mp):
    from replication_of_minute_frequency_factor_tpu_torch import eval_ops
    real = eval_ops.ic_series
    mp.setattr(eval_ops, "ic_series",
               lambda *a: tuple(t + 1e-3 for t in real(*a)))


def _distort_resample(mp):
    from replication_of_minute_frequency_factor_tpu_torch.minfreq import (
        MinFreqFactor)
    real = MinFreqFactor._finish_final_exposure
    mp.setattr(MinFreqFactor, "_finish_final_exposure",
               lambda self, c, d, out, n: real(self, c, d, out * 1.01, n))


def _distort_l3(mp):
    from replication_of_minute_frequency_factor_tpu_torch.factor import (
        Factor)
    real = Factor.ic_test

    def off(self, *a, **kw):
        out = real(self, *a, **kw)
        self.IC = self.IC + 1e-2 if self.IC is not None else self.IC
        return out
    mp.setattr(Factor, "ic_test", off)


def _distort_group(mp):
    from replication_of_minute_frequency_factor_tpu_torch import factor
    real = factor.aggregate_period_returns

    def off(*a, **kw):
        periods, ret = real(*a, **kw)
        return periods, ret * 1.01
    mp.setattr(factor, "aggregate_period_returns", off)


def _distort_search(mp):
    from replication_of_minute_frequency_factor_tpu_torch import search
    mp.setattr(search, "eval_programs", _scale(search.eval_programs, 1.01))


def _distort_pipeline(mp):
    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    mp.setattr(pipeline, "_read_ledger", lambda path: [])


def _distort_parallel(mp):
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        collectives)
    mp.setattr(collectives, "xs_masked_std",
               _scale(collectives.xs_masked_std, 1.01))


def _distort_refdiff(mp):
    from replication_of_minute_frequency_factor_tpu_torch.oracle import (
        kernels)
    real = kernels.ORACLE_FACTORS["vol_return1min"]
    mp.setitem(kernels.ORACLE_FACTORS, "vol_return1min",
               lambda g: real(g) * 1.01)


#: harness -> (distortion, seed window in which every seed must fail)
DISTORTIONS = {
    "parity": (_distort_parity, (0, 2)),
    "rolling": (_distort_rolling, (11, 12)),
    "wire": (_distort_wire, (2, 4)),
    "grid": (_distort_grid, (0, 2)),
    "eval": (_distort_eval, (0, 2)),
    "resample": (_distort_resample, (0, 2)),
    "l3": (_distort_l3, (0, 2)),
    "group": (_distort_group, (0, 2)),
    "search": (_distort_search, (2, 5)),
    "pipeline": (_distort_pipeline, (10_000, 10_002)),
    "parallel": (_distort_parallel, (0, 2)),
    "refdiff": (_distort_refdiff, (0, 2)),
}


@pytest.mark.parametrize("name", fuzz.HARNESSES)
def test_each_harness_fails_on_its_distortion(monkeypatch, capsys, name):
    distort, (lo, hi) = DISTORTIONS[name]
    distort(monkeypatch)
    kw = {"tree": STAND_IN} if name == "refdiff" else {}
    fails = fuzz.harness(name).run(lo, hi, "cpu", **kw)
    out = capsys.readouterr().out
    assert fails == list(range(lo, hi)), out
    assert f"DONE {hi - lo} seeds, {hi - lo} failures" in out


# ---------------------------------------------------------------------------
# the rolling harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 13, 43])
def test_rolling_f64_oracle_is_the_per_window_one(seed):
    """The vectorised f64 window statistics equal both packages' naive
    per-window reference."""
    from replication_of_minute_frequency_factor_tpu.ops.rolling import (
        _f64_reference as jax_ref)
    from replication_of_minute_frequency_factor_tpu_torch.ops.rolling import (
        _f64_reference as port_ref)

    case = scenarios.rolling_case(seed)
    low, high, mask = (case[k][:4, :300] for k in ("low", "high", "mask"))
    mask = mask | (np.arange(mask.shape[-1]) % 97 != 0)
    for w in (1, 7, 50, low.shape[-1]):
        got = frolling.f64_window_stats(low, high, mask, w)
        for ref in (jax_ref(low, high, mask, w), port_ref(low, high, mask, w)):
            np.testing.assert_array_equal(got["valid"], ref["valid"])
            v = ref["valid"]
            assert v.any()
            for k in ("mean_x", "mean_y", "cov", "var_x", "var_y"):
                np.testing.assert_allclose(got[k][v], ref[k][v],
                                           rtol=1e-9, atol=1e-12)


def test_rolling_cases_sweep_the_kernels_branches():
    """Over the card's phase-19 window the cases reach every vector width
    (L % 4, L % 2, odd), rows of more than 128 tiles and more than 128
    chunks, windows 1, 50 and past L, past-the-span rows and 10k-row
    cases; and all-masked rows and constant windows occur."""
    seen = set()
    for seed in range(200):
        rows, L, w = scenarios.rolling_shape(seed)
        seen.update(k for k, hit in (
            ("L%4", L % 4 == 0), ("L%2", L % 4 == 2), ("odd", L % 2 == 1),
            ("tiles>128", 4 * 128 < L <= scenarios.TILED_MAX_L),
            ("chunks>128", L > 4 * 128 and L % 4 == 0), ("w=1", w == 1),
            ("w=50", w == 50), ("w>L", w > L),
            ("past span", L > scenarios.TILED_MAX_L),
            ("rows>10k", rows > 10_000)) if hit)
    assert len(seen) == 10, sorted(seen)
    assert scenarios.rolling_shape(11) == (1, 210, 50)
    c = scenarios.rolling_case(11)
    assert c["low"].shape == (1, 210) and c["window"] == 50
    masks = [scenarios.rolling_case(s)["mask"] for s in (14, 17)]
    assert any(rows > 1 and not m.any(-1).all() for m in masks
               for rows in (m.shape[0],))
    # seed 7: a row holds one value over 129 slots, windows of 50 inside
    eq = np.diff(scenarios.rolling_case(7)["low"], axis=-1) == 0
    assert any(np.convolve(r, np.ones(49), "valid").max() == 49
               for r in eq)


@pytest.mark.parametrize("seed", [11, 43, 50])
def test_rolling_allowance_covers_another_summation_order(seed):
    """The plain version summed one window offset at a time (another
    order of the same f32 products, as the kernels' is) stays within the
    card path's tolerance of the default chunked sum."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import rolling

    case = scenarios.rolling_case(seed)
    w = case["window"]
    args = rolling.second_moment_inputs(
        *(torch.from_numpy(case[k][:64]) for k in ("low", "high", "mask")),
        w)
    valid = (rolling._windowed_sum(torch.from_numpy(case["mask"][:64]), w)
             > w - 0.5).numpy()
    assert valid.any()
    plain = frolling._stats(rolling._second_moments_conv(*args, w), w)
    other = frolling._stats(
        rolling._second_moments_conv(*args, w, chunk=1), w)
    frolling._close("chunk=1", other, plain, valid,
                    frolling.rounding_allowance(plain, w))


def test_rolling_cpu_check_fails_on_an_off_oracle(monkeypatch):
    real = frolling.f64_window_stats

    def off(*a, **kw):
        out = real(*a, **kw)
        out["cov"] = out["cov"] + 1e-3
        return out
    monkeypatch.setattr(frolling, "f64_window_stats", off)
    case = scenarios.rolling_case(11)  # one full row of prices near 3
    with pytest.raises(AssertionError, match="cov out of tolerance"):
        frolling.check_cpu(case)


def _stand_in_kernels(monkeypatch, off=1.0, sticky=False, which=("tiled",)):
    """The card path rehearsed on the CPU: both kernels replaced by the
    plain version behind the wrapper's refusals (the tiled kernel's
    alignment and span, the rowwise kernel's span); ``off`` scales the
    s_xy of the kernels in ``which``; ``sticky`` makes a refused launch
    fail the next launch too, as a stale CUDA error would."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)
    state = {"stale": False}

    def launch(variant, tensors, window):
        if state["stale"]:
            raise RuntimeError("stale error from the last launch")
        L = tensors[0].shape[-1]
        if variant == "tiled" and any(t.data_ptr() % 16 for t in tensors):
            raise ValueError("not 16-byte aligned")
        span = L if variant == "tiled" else L + window - 1
        if span > scenarios.TILED_MAX_L:
            state["stale"] = sticky
            raise RuntimeError("invalid argument")
        s_xx, s_yy, s_xy = rolling_cuda.second_moments_plain(*tensors,
                                                              window)
        if variant in which:
            s_xy = s_xy * off
        return s_xx, s_yy, s_xy

    monkeypatch.setattr(rolling_cuda, "second_moments",
                        lambda *a: launch(rolling_cuda.kernel_for(a[4]),
                                          a[:4], a[4]))
    monkeypatch.setattr(rolling_cuda, "_second_moments_rowwise",
                        lambda *a: launch("rowwise", a[:4], a[4]))


#: cases of every branch of the card path: window 50 (tiled, rowwise,
#: misaligned), another window, past the span (34: the rowwise kernel
#: refuses; 150: both refuse)
CARD_PATH_SEEDS = (11, 17, 43, 34, 56, 150)


@pytest.mark.parametrize("seed", CARD_PATH_SEEDS)
def test_rolling_card_path_rehearsed_on_the_cpu(monkeypatch, seed):
    _stand_in_kernels(monkeypatch)
    frolling.check_case(seed, torch.device("cpu"), card=True)


@pytest.mark.parametrize("seed,which,match", [
    (11, ("tiled",), "tiled s_xy differs from rowwise"),
    (43, ("rowwise",), "rowwise .* cov out of tolerance"),
])
def test_rolling_card_path_catches_an_off_kernel(monkeypatch, seed, which,
                                                 match):
    _stand_in_kernels(monkeypatch, off=1.01, which=which)
    with pytest.raises(AssertionError, match=match):
        frolling.check_case(seed, torch.device("cpu"), card=True)


def test_rolling_card_path_catches_a_stale_error(monkeypatch):
    _stand_in_kernels(monkeypatch, sticky=True)
    with pytest.raises(AssertionError, match="next valid launch failed"):
        frolling.check_case(150, torch.device("cpu"), card=True)


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------

def test_chip_smoke_reads_the_comparator_copy():
    """The smoke's tolerance tables are the copy's, which
    tests/test_torch_fuzz_parity.py holds to tests/test_parity.py; it no
    longer parses the JAX suite's source for them."""
    src = (REPO / "chip_smoke.py").read_text()
    assert "tables = comparator.tables()" in src
    assert "test_parity.py\"" not in src and "ast.parse" not in src
