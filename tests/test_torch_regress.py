"""The port's bench-series regression gate (``telemetry/regress.py``)
against the JAX package's, on the same inputs.

One case per test of tests/test_regress.py, plus the CLI options that file
drives only through a subprocess: each case builds the same records the
same way (the repo's ``BENCH_r*.json``, tests/fixtures/regress_injected/
and the temporary records that file writes), runs them through both
modules, and requires equal results compared as JSON — the loaders,
``derive_records``, ``effective_methodology``, ``stage_diff``,
``evaluate``, and the CLI in process through ``main(argv)`` (exit code and
stdout). A last case folds the spans of the port's own ``metrics.jsonl``
through both modules' ``--telemetry``.
"""

import contextlib
import io
import json
import os

import pytest

from replication_of_minute_frequency_factor_tpu.telemetry import (
    regress as jax_regress)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    regress as port_regress)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
INJECTED = os.path.join(HERE, "fixtures", "regress_injected")

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _dump(path, doc):
    with open(path, "w") as fh:
        json.dump(doc, fh)


def _write_series(root, values, metric="toy_wall", methodology="mA",
                  stages=None, start=1):
    for i, v in enumerate(values):
        rec = {"metric": metric, "value": v, "unit": "s"}
        if methodology is not None:
            rec["methodology"] = methodology
        if stages is not None:
            rec["stages"] = stages[i]
        _dump(os.path.join(root, f"BENCH_r{start + i:02d}.json"),
              {"n": start + i, "parsed": rec})


def _bank(root, recs):
    """``recs`` as the wrapped BENCH_r01.. trajectory under ``root``."""
    for i, rec in enumerate(recs):
        _dump(os.path.join(root, f"BENCH_r{i + 1:02d}.json"),
              {"n": i + 1, "parsed": rec})


def _cli(mod, *argv):
    """``mod.main(argv)`` in process: (exit code, stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([str(a) for a in argv])
    return rc, buf.getvalue().splitlines()


def _eval_dir(mod, root, **kw):
    return mod.evaluate(mod.load_bench_series(str(root)), **kw)


# --------------------------------------------------------------------------
# record builders (tests/test_regress.py's, verbatim in effect)
# --------------------------------------------------------------------------


def _serve_rec(value=50.0, p99=12.0, peak=1e9, available=True,
               methodology="r8_serve_v1"):
    rec = {"metric": "serveN_qps", "value": value,
           "methodology": methodology, "p99_ms": p99}
    if peak is not None:
        rec["hbm"] = {"available": available, "peak_bytes": peak,
                      "devices": {}}
    return rec


def _sharded_rec(value=100.0, skew=1.1, waste=0.02, available=True,
                 methodology="r7_resident_sharded_v1"):
    rec = {"metric": "cicc58_sharded_wall", "value": value,
           "methodology": methodology, "n_shards": 8}
    if skew is not None:
        rec["mesh"] = {"available": available, "shard_skew_ratio": skew,
                       "pad_waste_frac": waste}
    return rec


def _fh_rec(value=80.0, widen=0.01, cov=0.97, available=True, slices=928,
            methodology="r10_resident_v3"):
    return {"metric": "cicc58_5000tickers_1yr_wall", "value": value,
            "methodology": methodology,
            "factor_health": {"available": available, "widen_rate": widen,
                              "coverage_frac": cov,
                              "widen": {"slices": slices,
                                        "widened": int(widen * slices)}}}


def _r10_rec(value=80.0, wire_bpd=600_000.0, result_bpd=610_000.0,
             methodology="r10_resident_v3"):
    return {"metric": "cicc58_5000tickers_1yr_wall", "value": value,
            "methodology": methodology,
            "result_wire": {"enabled": True, "ratio_vs_f32": 1.9},
            "wire": {"bytes_per_day": wire_bpd},
            "result": {"bytes_per_day": result_bpd}}


def _rec_2d(skew_days=1.05, skew_tickers=1.0, available=True):
    rec = _sharded_rec(available=available,
                       methodology="r12_resident_2d_v1")
    rec["metric"] = "cicc58_2d_wall"
    rec["mesh_shape"] = [2, 4]
    rec["mesh"]["axes"] = {
        "days": {"shard_time_s": {"day0": 1.0, "day1": skew_days},
                 "skew_ratio": skew_days},
        "tickers": {"shard_time_s": {"ticker0": 1.0},
                    "skew_ratio": skew_tickers}}
    return rec


def _discover_rec(value=5000.0, cps=None, generations=6, compiles=0,
                  syncs=1.0, methodology="r13_discover_v1"):
    return {"metric": "discover15slot_512tickers_candidates_per_s",
            "value": value, "unit": "candidates/s",
            "methodology": methodology,
            "discover": {"population": 2048, "generations": generations,
                         "candidates_per_s": value if cps is None else cps,
                         "compiles_during_loop": compiles,
                         "syncs_per_generation": syncs, "n_shards": 4}}


def _slo_block(available=True, frames=12, wbr=0.5):
    return {"available": available, "frames": frames,
            "worst_burn_rate": wbr, "alerts": 0, "objectives": {}}


def _snapshot_rec(value=0.8, flat=1.02, compiles=0, bars=240,
                  methodology="r14_stream_snapshot_v1"):
    avail = compiles == 0 and bars // 4 >= 4
    return {"metric": "stream_snapshot58_64tickers_fast_p50_ms",
            "value": value, "unit": "ms", "finalize_impl": "fast",
            "methodology": methodology,
            "snapshot": {"bars": bars, "p50_ms": value, "p99_ms": value * 2,
                         "p50_flat_ratio": round(flat * 0.98, 4),
                         "p99_flat_ratio": flat,
                         "compiles_during_profile": compiles,
                         "available": avail}}


def _edge_rec(value=700.0, wbpa=1436.0, answers=96, available=True,
              methodology="r15_serve_edge_v1"):
    rec = _serve_rec(value=value, peak=None, methodology=methodology)
    rec["transport"] = "edge"
    rec["encoding"] = "wire"
    rec["edge"] = {"available": available, "transport": "edge",
                   "wire_answers": answers,
                   "wire_bytes": int(wbpa * answers),
                   "wire_bytes_per_answer": wbpa,
                   "json_bytes_per_answer": wbpa * 5,
                   "ab_ratio": 5.0, "http_failures": 0}
    return rec


def _gate(mod, root, recs, candidates):
    """Bank ``recs``, then the trajectory and ``evaluate`` of each
    candidate against it."""
    _bank(root, recs)
    entries = mod.load_bench_series(str(root))
    return [entries] + [mod.evaluate(entries, candidate=c)
                        for c in candidates]


def _check(mod, root, cand, banked=None, against=None):
    """The CLI's ``--check`` of ``cand`` against ``against`` (default:
    ``root`` with ``banked`` written there as BENCH_r01.json)."""
    if banked is not None:
        _dump(os.path.join(root, "BENCH_r01.json"), banked)
    path = os.path.join(root, "candidate.json")
    _dump(path, cand)
    return _cli(mod, against or root, "--check", path)


# --------------------------------------------------------------------------
# loading / grouping
# --------------------------------------------------------------------------


@scenario
def load_bench_series_wrapper_bare_and_tail(mod, tmp):
    _dump(tmp / "BENCH_r01.json",
          {"n": 1, "parsed": {"metric": "m", "value": 1.0}})
    _dump(tmp / "BENCH_r02.json", {"metric": "m", "value": 2.0})
    _dump(tmp / "BENCH_r03.json",
          {"n": 3, "rc": 0,
           "tail": 'noise\n{"metric": "m", "value": 3.0}\n'})
    return mod.load_bench_series(str(tmp))


@scenario
def stale_carry_is_not_a_data_point(mod, tmp):
    _dump(tmp / "BENCH_r01.json", {"n": 1, "parsed": {
        "metric": "m_cpu", "value": 600.0,
        "stale_tpu_headline": {"metric": "m", "value": 148.0}}})
    return mod.load_bench_series(str(tmp))


@scenario
def legacy_records_join_the_stream_series(mod, tmp):
    return [mod.LEGACY_METHODOLOGY, mod.DEFAULT_SESSION,
            mod.DEFAULT_TOLERANCE,
            mod.effective_methodology({}),
            mod.effective_methodology({"methodology": "r5_resident_v1"}),
            mod.effective_methodology({"session": "cn_ashare_240"}),
            mod.effective_methodology({"methodology": "m",
                                       "session": "us_390"}),
            mod.effective_methodology({"methodology": "m+session=us_390",
                                       "session": "us_390"})]


# --------------------------------------------------------------------------
# evaluation semantics
# --------------------------------------------------------------------------


@scenario
def gate_flags_injected_regression_with_stage_diff(mod, tmp):
    entries = mod.load_bench_series(INJECTED)
    return [mod.evaluate(entries),
            mod.stage_diff(entries[:-1], entries[-1]["record"])]


@scenario
def gate_quiet_within_tolerance(mod, tmp):
    _write_series(str(tmp), [100.0, 102.0, 99.0, 101.0])
    return _eval_dir(mod, tmp)


@scenario
def declared_methodology_break_stays_quiet(mod, tmp):
    _write_series(str(tmp), [100.0, 101.0, 99.0])
    _dump(tmp / "BENCH_r04.json", {"n": 4, "parsed": {
        "metric": "toy_wall", "value": 130.0, "methodology": "mB"}})
    return _eval_dir(mod, tmp)


@scenario
def undeclared_break_is_flagged(mod, tmp):
    _write_series(str(tmp), [100.0, 101.0, 99.0, 130.0],
                  stages=[{"compute": v - 10, "io": 10.0, "peak_MB": 1.0}
                          for v in (100.0, 101.0, 99.0, 130.0)])
    return _eval_dir(mod, tmp)


@scenario
def candidate_mode_gates_against_full_series(mod, tmp):
    _write_series(str(tmp), [100.0, 102.0, 98.0])
    entries = mod.load_bench_series(str(tmp))
    return [mod.evaluate(entries, candidate={
        "metric": "toy_wall", "value": v, "methodology": m})
        for v, m in ((101.0, "mA"), (120.0, "mA"), (500.0, "mZ"))]


@scenario
def faster_is_also_a_deviation(mod, tmp):
    _write_series(str(tmp), [100.0, 101.0, 99.0, 80.0])
    return _eval_dir(mod, tmp)


@scenario
def tolerance_moves_the_flag(mod, tmp):
    _write_series(str(tmp), [100.0, 101.0, 99.0, 108.0])
    entries = mod.load_bench_series(str(tmp))
    return [mod.evaluate(entries, tolerance=t) for t in (0.05, 0.1, 0.0)]


# --------------------------------------------------------------------------
# telemetry JSONL cross-check
# --------------------------------------------------------------------------


@scenario
def telemetry_span_folding(mod, tmp):
    mdir = tmp / "tel"
    mdir.mkdir(exist_ok=True)
    with open(mdir / "metrics.jsonl", "w") as fh:
        fh.write(json.dumps({
            "schema": 1, "ts": 0, "kind": "histogram",
            "name": "span_seconds", "labels": {"span": "device"},
            "count": 4, "sum": 8.0, "min": 1.0, "max": 3.0,
            "p50": 2.0, "p95": 3.0}) + "\n")
        fh.write(json.dumps({
            "schema": 1, "ts": 0, "kind": "counter", "name": "x",
            "labels": {}, "value": 1}) + "\n")
        fh.write("not json\n\n")
    found = mod.find_metrics_jsonl(str(tmp))
    return [found, mod.load_telemetry_spans(found),
            mod.find_metrics_jsonl(str(mdir / "metrics.jsonl")),
            mod.load_telemetry_spans([str(tmp / "missing.jsonl")])]


# --------------------------------------------------------------------------
# CLI contract
# --------------------------------------------------------------------------


@scenario
def cli_reports_banked_series_and_exits_zero(mod, tmp):
    return _cli(mod, REPO)


@scenario
def cli_exits_nonzero_on_injected_fixture_strict(mod, tmp):
    return _cli(mod, INJECTED, "--strict")


@scenario
def cli_tolerance_and_out(mod, tmp):
    out = tmp / f"verdict_{mod.__name__.split('.')[0]}.json"
    rc, lines = _cli(mod, INJECTED, "--strict", "--tolerance", "0.5",
                     "--out", out)
    with open(out) as fh:
        return [rc, lines, fh.read()]


@scenario
def cli_check_mode_gates_candidate(mod, tmp):
    return [_check(mod, tmp, {"metric": "toy_wall", "value": v,
                              "methodology": "fixture_v1"},
                   against=INJECTED)
            for v in (120.0, 100.5)]


@scenario
def cli_no_input_exits_two(mod, tmp):
    bad = tmp / "bad.json"
    with open(bad, "w") as fh:
        fh.write("{")
    empty = tmp / "empty.json"
    _dump(empty, {"n": 1})
    return [_cli(mod, tmp),
            _cli(mod, tmp, "--check", bad),
            _cli(mod, tmp, "--check", empty),
            _cli(mod, tmp, "--check", tmp / "missing.json")]


@scenario
def cli_check_r8_serve_break_is_declared(mod, tmp):
    return _check(mod, tmp, {
        "metric": "serve58_1024tickers_qps", "value": 512.4,
        "unit": "req/s", "methodology": "r8_serve_v1",
        "p50_ms": 41.0, "p99_ms": 120.0,
        "levels": {"1": {"qps": 88.0}, "32": {"qps": 512.4}},
        "serve": {"cache_hits": 180, "coalesced_dispatches": 12,
                  "compiles_during_load": 0}}, against=REPO)


@scenario
def cli_check_r9_stream_break_is_declared(mod, tmp):
    return _check(mod, tmp, {
        "metric": "stream58_1024tickers_bars_per_s", "value": 83000.0,
        "unit": "bars/s", "methodology": "r9_stream_intraday_v1",
        "p50_ms": 0.7, "p99_ms": 2.4,
        "levels": {"1": {"bars_per_s": 1400.0},
                   "64": {"bars_per_s": 83000.0}},
        "stream": {"updates": 2880, "bars": 170000,
                   "compiles_during_load": 0,
                   "parity_mismatched": []}}, against=REPO)


@scenario
def cli_check_r11_fleet_break_is_declared(mod, tmp):
    return _check(mod, tmp, {
        "metric": "fleet58_1024tickers_qps", "value": 910.0,
        "unit": "req/s", "methodology": "r11_fleet_v1",
        "p50_ms": 38.0, "p99_ms": 140.0, "live_replicas": 2,
        "replicas": {"1": {"levels": {"64": {"qps": 520.0}}},
                     "2": {"levels": {"64": {"qps": 910.0}}}},
        "pod": {"counter_totals": {"checked": 40, "mismatched": 0},
                "affinity_hits": 200}}, against=REPO)


@scenario
def cli_check_r7_sharded_break_is_declared(mod, tmp):
    return _check(mod, tmp, {
        "metric": "cicc58_5000tickers_1yr_wall", "value": 84.8,
        "n_shards": 8, "methodology": "r7_resident_sharded_v1"},
        against=REPO)


# --------------------------------------------------------------------------
# derived sub-series
# --------------------------------------------------------------------------


@scenario
def derive_records_lifts_p99_and_available_hbm(mod, tmp):
    return mod.derive_records(_serve_rec())


@scenario
def unavailable_hbm_never_seeds_a_baseline(mod, tmp):
    return [mod.derive_records(_serve_rec(available=False)),
            mod.derive_records({"metric": "m", "value": 1.0}),
            mod.derive_records({"metric": "", "value": 1.0, "p99_ms": 2}),
            mod.derive_records({"value": 1.0, "p99_ms": True})]


@scenario
def derived_series_gate_and_declared_break(mod, tmp):
    return _gate(mod, tmp, [_serve_rec(peak=1e9), _serve_rec(peak=1.02e9)],
                 [_serve_rec(), _serve_rec(p99=24.0), _serve_rec(peak=2e9),
                  _serve_rec(peak=5e9, available=False),
                  _serve_rec(methodology="r10_new")])


@scenario
def derive_records_lifts_available_mesh_series(mod, tmp):
    return mod.derive_records(_sharded_rec())


@scenario
def unavailable_mesh_never_seeds_a_baseline(mod, tmp):
    return [mod.derive_records(_sharded_rec(available=False)),
            mod.derive_records({"metric": "m", "value": 1.0,
                                "mesh": None})]


@scenario
def mesh_series_gate_both_directions(mod, tmp):
    return _gate(mod, tmp, [_sharded_rec(skew=1.1), _sharded_rec(skew=1.12)],
                 [_sharded_rec(), _sharded_rec(skew=2.2),
                  _sharded_rec(waste=0.04),
                  _sharded_rec(skew=9.0, available=False),
                  _sharded_rec(methodology="r10_mesh2d")])


@scenario
def derive_records_lifts_available_factor_health(mod, tmp):
    return mod.derive_records(_fh_rec())


@scenario
def unavailable_or_wireless_factor_health_never_seeds(mod, tmp):
    return [mod.derive_records(_fh_rec(available=False)),
            mod.derive_records(_fh_rec(widen=0.0, slices=0))]


@scenario
def factor_health_series_gate_both_directions(mod, tmp):
    return _gate(mod, tmp, [_fh_rec(widen=0.010), _fh_rec(widen=0.0102)],
                 [_fh_rec(), _fh_rec(widen=0.08), _fh_rec(cov=0.5),
                  _fh_rec(widen=0.5, cov=0.1, available=False),
                  _fh_rec(methodology="r13_newloop")])


@scenario
def derive_records_lifts_byte_program(mod, tmp):
    return [mod.derive_records(_r10_rec()),
            mod.derive_records({"metric": "m", "value": 1.0,
                                "wire": {"bytes_per_day": 0}})]


@scenario
def byte_series_flag_both_directions(mod, tmp):
    return _gate(mod, tmp, [_r10_rec(result_bpd=610_000.0),
                            _r10_rec(result_bpd=612_000.0)],
                 [_r10_rec(), _r10_rec(result_bpd=1_200_000.0),
                  _r10_rec(result_bpd=300_000.0),
                  _r10_rec(wire_bpd=1_500_000.0)])


@scenario
def cli_check_r10_break_is_declared(mod, tmp):
    _dump(tmp / "BENCH_r09.json", {"n": 9, "parsed": {
        "metric": "cicc58_5000tickers_1yr_wall", "value": 146.2,
        "methodology": "r6_resident_v2"}})
    return _check(mod, tmp, _r10_rec(value=80.0))


@scenario
def derive_records_lifts_per_axis_skew_from_2d_records(mod, tmp):
    return mod.derive_records(_rec_2d())


@scenario
def per_axis_skew_gated_on_availability_and_watermarks(mod, tmp):
    hollow = _rec_2d()
    hollow["mesh"]["axes"]["days"]["shard_time_s"] = {}
    odd = _rec_2d()
    odd["mesh"]["axes"]["days"] = "broken"
    return [mod.derive_records(_rec_2d(available=False)),
            mod.derive_records(hollow), mod.derive_records(odd),
            mod.derive_records(_sharded_rec())]


@scenario
def cli_check_r12_2d_break_is_declared(mod, tmp):
    return _check(mod, tmp, _rec_2d(), banked=_sharded_rec())


@scenario
def derive_records_lifts_warm_discover_series(mod, tmp):
    return mod.derive_records(_discover_rec())


@scenario
def cold_or_chatty_discover_never_seeds(mod, tmp):
    return [mod.derive_records(r) for r in (
        _discover_rec(generations=0), _discover_rec(compiles=2),
        _discover_rec(syncs=2.0), _discover_rec(syncs=True),
        {"metric": "cicc58_wall", "value": 60.0,
         "methodology": "r6_resident_v2"})]


@scenario
def discover_series_gate_both_directions(mod, tmp):
    return _gate(mod, tmp, [_discover_rec(value=5000.0),
                            _discover_rec(value=5100.0)],
                 [_discover_rec(value=5040.0), _discover_rec(value=2000.0),
                  _discover_rec(value=9000.0),
                  _discover_rec(value=5050.0, syncs=3.0),
                  _discover_rec(value=900.0,
                                methodology="r14_discover_v2")])


@scenario
def cli_check_r13_break_is_declared(mod, tmp):
    return _check(mod, tmp, _discover_rec(), banked=_sharded_rec())


# --------------------------------------------------------------------------
# SLO burn, snapshot flatness and binary-edge sub-series
# --------------------------------------------------------------------------


@scenario
def derive_records_lifts_slo_burn_rate_series(mod, tmp):
    rec = _serve_rec()
    rec["slo"] = _slo_block(wbr=2.5)
    return mod.derive_records(rec)


@scenario
def unsampled_slo_never_seeds_burn_series(mod, tmp):
    out = []
    for slo in (None, {}, "broken", _slo_block(available=False),
                _slo_block(frames=0), _slo_block(frames="12"),
                {"available": True, "frames": 12}, _slo_block(wbr=True),
                _slo_block(wbr="2.5"), _slo_block(wbr=-0.5)):
        rec = _serve_rec()
        if slo is not None:
            rec["slo"] = slo
        out.append(mod.derive_records(rec))
    return out


@scenario
def burn_rate_series_gates_like_any_other(mod, tmp):
    def rec(wbr):
        r = _serve_rec()
        r["slo"] = _slo_block(wbr=wbr)
        return r
    return _gate(mod, tmp, [rec(0.5), rec(0.52)], [rec(0.51), rec(5.0)])


@scenario
def derive_records_lifts_available_snapshot_flatness(mod, tmp):
    return mod.derive_records(_snapshot_rec(flat=1.05))


@scenario
def cold_or_short_snapshot_profile_never_seeds(mod, tmp):
    unmeasured = _snapshot_rec()
    unmeasured["snapshot"]["p99_flat_ratio"] = None
    broken = _snapshot_rec()
    broken["snapshot"] = "broken"
    return [mod.derive_records(r) for r in (
        _snapshot_rec(compiles=2), _snapshot_rec(bars=8), unmeasured,
        broken, {"metric": "cicc58_wall", "value": 60.0,
                 "methodology": "r6_resident_v2"})]


@scenario
def snapshot_flatness_gates_both_directions(mod, tmp):
    return _gate(mod, tmp, [_snapshot_rec(flat=1.02),
                            _snapshot_rec(flat=1.04)],
                 [_snapshot_rec(flat=1.03), _snapshot_rec(flat=3.0),
                  _snapshot_rec(flat=0.1),
                  _snapshot_rec(flat=1.03, compiles=3),
                  _snapshot_rec(flat=0.2, methodology="r15_snapshot_v2")])


@scenario
def derive_records_lifts_wire_bytes_per_answer(mod, tmp):
    return mod.derive_records(_edge_rec())


@scenario
def answerless_or_unavailable_edge_never_seeds(mod, tmp):
    bad = [_edge_rec(available=False), _edge_rec(answers=0)]
    rec = _edge_rec()
    rec["edge"]["wire_answers"] = "96"
    bad.append(rec)
    for wbpa in (None, True, "1436", 0, -5.0):
        rec = _edge_rec()
        rec["edge"]["wire_bytes_per_answer"] = wbpa
        bad.append(rec)
    rec = _edge_rec()
    rec["edge"] = "broken"
    bad += [rec, _serve_rec(peak=None)]
    return [mod.derive_records(r) for r in bad]


@scenario
def wire_bytes_series_gate_both_directions(mod, tmp):
    legacy = _edge_rec(wbpa=7000.0,
                       methodology="r15_serve_edge_v1+transport=legacy")
    legacy["transport"] = "legacy"
    legacy["edge"]["transport"] = "legacy"
    return _gate(mod, tmp, [_edge_rec(wbpa=1430.0), _edge_rec(wbpa=1440.0)],
                 [_edge_rec(wbpa=1436.0), _edge_rec(wbpa=7000.0),
                  _edge_rec(wbpa=200.0),
                  _edge_rec(wbpa=7000.0, answers=0), legacy])


@scenario
def stage_diff_rows_for_one_sided_stages(mod, tmp):
    base = [{"record": {"stages": {"io": 1.0, "compute": 4.0,
                                   "peak_MB": 9.0, "flag": True}}},
            {"record": {"stages": {"io": 1.2, "compute": 4.4,
                                   "gone": 0.5}}}]
    latest = {"stages": {"io": 1.1, "compute": 9.0, "new": 2.0,
                         "wall_ms": 3.0}}
    return [mod.stage_diff(base, latest),
            mod.stage_diff([], {"stages": None}),
            mod.stage_diff(base, {"stages": {"io": 0.0}})]


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_matches_the_jax_module(name, tmp_path):
    """The same scenario through the JAX module and the port's, on the same
    files: equal results compared as JSON."""
    fn = SCENARIOS[name]
    want = json.dumps(fn(jax_regress, tmp_path), sort_keys=True)
    got = json.dumps(fn(port_regress, tmp_path), sort_keys=True)
    assert got == want
    assert want not in ("[]", "null", "{}")


def test_port_cli_contract(tmp_path):
    """The exit codes on their own: 0 on a report, 1 flagged under
    --strict or --check, 2 on no usable input; one JSON line each."""
    rc, lines = _cli(port_regress, REPO)
    assert rc == 0 and len(lines) == 1 and json.loads(lines[0])["records"]
    rc, lines = _cli(port_regress, INJECTED, "--strict")
    verdict = json.loads(lines[0])
    assert rc == 1 and verdict["flagged"][0]["metric"] == "toy_wall"
    assert verdict["groups"][0]["stage_diff"][0]["stage"] == "compute"
    rc, lines = _cli(port_regress, tmp_path)
    assert rc == 2 and json.loads(lines[0])["ok"] is False
    assert port_regress.DEFAULT_TOLERANCE == 0.05


def test_telemetry_folds_the_ports_own_spans(tmp_path):
    """The port's ``compute_exposures`` on the CPU with its telemetry
    written into a temporary directory: both modules' ``--telemetry``
    fold the same spans from that metrics.jsonl, one per driver stage,
    counted per day (io) and per batch (the rest)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from replication_of_minute_frequency_factor_tpu_torch.config import (
        Config)
    from replication_of_minute_frequency_factor_tpu_torch.data.synthetic import (  # noqa: E501
        synth_day)
    from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
        compute_exposures)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry)

    kline = tmp_path / "kline"
    kline.mkdir()
    rng = np.random.default_rng(0)
    for ds in ("2024-01-02", "2024-01-03", "2024-01-04"):
        cols = synth_day(rng, n_codes=6, date=ds)
        pq.write_table(pa.table(
            {"code": pa.array([str(c) for c in cols["code"]]),
             **{k: pa.array(cols[k]) for k in (
                 "time", "open", "high", "low", "close", "volume")}}),
            str(kline / (ds.replace("-", "") + ".parquet")))
    tel = Telemetry()
    cfg = Config(days_per_batch=2)
    compute_exposures(str(kline), ("mmt_am",), cfg=cfg, progress=False,
                      telemetry=tel, device="cpu",
                      cache_path=str(tmp_path / "cache.parquet"))
    tel.write(str(tmp_path / "tel"), cfg=cfg)
    (tmp_path / "bank").mkdir()
    _write_series(str(tmp_path / "bank"), [1.0, 1.0])
    outs = [_cli(mod, tmp_path / "bank", "--telemetry", tmp_path / "tel")
            for mod in (jax_regress, port_regress)]
    assert outs[0] == outs[1] and outs[1][0] == 0
    spans = json.loads(outs[1][1][0])["telemetry"]["spans"]
    assert {k: v["count"] for k, v in spans.items()} == {
        "io": 3, "grid": 2, "wire_encode": 2, "pack": 2, "launch": 2,
        "device": 2, "save": 1}
