"""The port's parity fuzz (``fuzz/parity.py``) and its copy of the parity
suite's comparator (``fuzz/comparator.py``) against tests/test_parity.py.

* the copy's tolerance tables are the suite's, value for value;
* the port's seed generators give the JAX package's days byte for byte
  (``synth_day`` with ``wide_scenario_kw`` and the suite's tier and
  multiday draws) at seeds of every tier;
* the suite's 20 pinned fuzz seeds and its kitchen-sink days go through
  ``compute_batch(device='cpu')`` against the f64 oracle, every cell
  judged by the suite's own ``_check_cell`` (the port in JAX's place) and
  by the copy, with the same verdict on every cell; the copy's degenerate
  beta skip sets and doc_pdf acceptance sets are the suite's on those
  days;
* each of the suite's seven injected distortions, applied to the port's
  factor, fails the copy on that factor; a device divide off by more
  than rounding trips the device channel's bound.
"""

import numpy as np
import pandas as pd
import pytest

import test_parity as tp
from replication_of_minute_frequency_factor_tpu.data import (
    synth_day as jax_synth_day)
from replication_of_minute_frequency_factor_tpu_torch.data import synth_day
from replication_of_minute_frequency_factor_tpu_torch.fuzz import (
    comparator as C, parity, scenarios)
from replication_of_minute_frequency_factor_tpu_torch.models import registry

PINNED = scenarios.PINNED_SEEDS


def _suite_seed_lists():
    """``{test name: seeds}`` of test_parity.py's seed parametrizations,
    read from its source."""
    import ast

    out = {}
    for node in ast.parse(open(tp.__file__).read()).body:
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            if (isinstance(dec, ast.Call) and dec.args
                    and isinstance(dec.args[0], ast.Constant)
                    and dec.args[0].value == "seed"
                    and isinstance(dec.args[1], ast.List)):
                out[node.name] = tuple(ast.literal_eval(dec.args[1]))
    return out


def test_pinned_seed_lists_are_the_suites():
    lists = _suite_seed_lists()
    assert lists["test_parity_boundary_regressions"] == \
        scenarios.BOUNDARY_SEEDS
    assert lists["test_parity_wide_scenario_regressions"] == \
        scenarios.WIDE_SEEDS
    assert lists["test_parity_kitchen_sink"] == scenarios.KITCHEN_SINK_SEEDS
    assert len(PINNED) == 24


@pytest.mark.parametrize("name", C.TABLE_NAMES)
def test_tables_are_test_paritys(name):
    assert C.tables()[name] == getattr(tp, name)
    assert type(C.tables()[name]) is type(getattr(tp, name))


def _jax_days(seed):
    """The days test_parity / tools/fuzz/fuzz_parity.py draw for
    ``seed``, on the JAX package's ``synth_day``."""
    rng = np.random.default_rng(seed)
    if seed < 10_000:
        return [jax_synth_day(rng, n_codes=10, missing_prob=0.12,
                              zero_volume_prob=0.12, constant_price_codes=2,
                              short_day_codes=3)]
    kw = tp.wide_scenario_kw(rng, big=seed >= 32_000)
    if seed >= 31_000 and rng.random() < 0.35:
        n_days = int(rng.integers(2, 4))
        return [jax_synth_day(rng, **kw, date=f"2024-01-{2 + i:02d}")
                for i in range(n_days)]
    return [jax_synth_day(rng, **kw)]


#: seeds of every tier: the historical shape, the wide shapes, the
#: multiday tier (31000 and 31069 batch their days, 31001 does not) and
#: the big universes (32007 batches)
GEN_SEEDS = (0, 739, 9999, 10000, 17777, 30202, 31000, 31001, 31069, 32005,
             32007, 32461, 32811)


@pytest.mark.parametrize("seed", GEN_SEEDS)
def test_generators_give_the_jax_days(seed):
    days = scenarios.parity_case(seed)
    want = _jax_days(seed)
    assert len(days) == len(want)
    for got, ref in zip(days, want):
        assert got.keys() == ref.keys()
        for k in ref:
            a, b = np.asarray(got[k]), np.asarray(ref[k])
            assert a.dtype == b.dtype, k
            assert a.tobytes() == b.tobytes(), k


def test_generator_tiers_take_each_branch():
    multi = [s for s in GEN_SEEDS if len(scenarios.parity_case(s)) > 1]
    assert 31069 in multi and any(s >= 32_000 for s in multi)
    assert not any(s < 31_000 for s in multi)


def test_kitchen_sink_day_is_the_suites():
    rng = np.random.default_rng(10)
    ref = jax_synth_day(rng, n_codes=10, missing_prob=0.1,
                        zero_volume_prob=0.1, constant_price_codes=1,
                        short_day_codes=2)
    got = scenarios.kitchen_sink_day(10)
    for k in ref:
        assert np.asarray(got[k]).tobytes() == np.asarray(ref[k]).tobytes()


def _pinned_days(seed):
    if seed in scenarios.KITCHEN_SINK_SEEDS:
        return [scenarios.kitchen_sink_day(seed)]
    return scenarios.parity_case(seed)


@pytest.mark.parametrize("seed", PINNED)
def test_pinned_seed_through_the_port_under_the_suites_comparator(seed):
    """Every cell judged twice: test_parity's ``_check_cell`` (whose
    failures fail the seed) and the copy's, with equal verdicts."""
    verdicts = []

    def judge(label, name, code, ov, jvv, noisy, failures, aux, pdf):
        theirs, ours = [], []
        tp._check_cell(label, name, code, ov, jvv, noisy, theirs, aux, pdf)
        C._check_cell(label, name, code, ov, jvv, noisy, ours, aux, pdf)
        verdicts.append((not theirs, not ours))
        failures.extend(theirs)

    parity.check_pinned(seed, device="cpu", judge=judge)
    assert len(verdicts) > 58 * 3
    assert all(a == b for a, b in verdicts)


@pytest.mark.parametrize("seed", PINNED)
def test_pinned_days_degenerate_beta_codes_are_the_suites(seed):
    for day in _pinned_days(seed):
        df = pd.DataFrame(day)
        assert C._degenerate_beta_codes(df) == tp._degenerate_beta_codes(df)


@pytest.mark.parametrize("seed", [120, 781, 30202, 30658, 0])
def test_pinned_days_doc_pdf_acceptance_is_the_suites(seed):
    """The seeds whose doc_pdf cells lean on the acceptance sets (the
    threshold band, tie merging, the 27-member tie group) and a kitchen
    sink."""
    for day in _pinned_days(seed):
        df = pd.DataFrame(day)
        assert C._doc_pdf_acceptable(df) == tp._doc_pdf_acceptable(df)


def test_a_failing_cell_fails_both_verdicts_alike():
    """The copy fails what the suite fails: an off value, a NaN where the
    oracle has a value, a wrong-signed inf, a doc_pdf rank outside every
    acceptance member."""
    pdf = C._lazy(lambda: {("c", "doc_pdf90"): {100.0}})
    for name, ov, v, aux in (
            ("vol_return1min", 1.0, 1.01, {}),
            ("mmt_am", 1.0, np.nan, {}),
            ("corr_pv", -np.inf, np.inf, {}),
            ("doc_pdf90", 50.0, 200.0, {"beta_num_scale": None}),
            ("doc_pdf90", 50.0, 101.0, {"beta_num_scale": None})):
        theirs, ours = [], []
        tp._check_cell("x", name, "c", ov, v, True, theirs, aux, pdf)
        C._check_cell("x", name, "c", ov, v, True, ours, aux, pdf)
        assert bool(theirs) == bool(ours)
    assert ours == []  # 101 is within the rank slack of member 100


@pytest.mark.parametrize("name,distort", [
    ("vol_return1min", lambda v: v * 1.01),
    ("mmt_am", lambda v: v + 1e-2),
    ("doc_pdf90", lambda v: v + 60.0),
    ("shape_skew", lambda v: v * 1.05),
    ("shape_skratio", lambda v: v * 1.1),
    ("corr_pv", lambda v: v * 1.05),
    ("mmt_ols_qrs", lambda v: v * 1.10),
])
def test_copy_detects_the_suites_injected_distortions(monkeypatch, name,
                                                      distort):
    """test_parity's looseness meta-test on the copy: after every
    acceptance mechanism, a distorted port factor still fails the
    compare on its own factor."""
    orig = registry.resolve(name)
    monkeypatch.setitem(registry.FACTORS, name,
                        lambda ctx: distort(orig(ctx)))
    rng = np.random.default_rng(0)
    with pytest.raises(AssertionError, match=f"mutated/{name}/"):
        parity.compare_days([synth_day(rng, n_codes=23, missing_prob=0.1)],
                            "mutated", noisy=True, device="cpu")


def test_device_channel_bound_rejects_wrong_divide(monkeypatch):
    real = C._eod_ret_device
    monkeypatch.setattr(C, "_eod_ret_device",
                        lambda bars, mask: real(bars, mask) * (1.0 + 1e-3))
    df = pd.DataFrame(synth_day(np.random.default_rng(0), n_codes=6))
    with pytest.raises(AssertionError, match="device arithmetic regression"):
        C._doc_pdf_acceptable(df)
