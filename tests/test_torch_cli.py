"""The port's command line vs the JAX package's, on the CPU.

tests/test_cli.py's workspace (8 synthetic day files of 8 tickers and a
daily PV parquet over their codes): ``compute`` then ``evaluate`` through
both CLIs, ``--device cpu`` for the port. The JSON lines carry the same
keys; ``compute``'s values are equal, ``evaluate``'s IC statistics within
rtol 1e-4 / atol 1e-6 (plus the 6-decimal rounding both print).
``list-factors`` prints the same text; an unknown factor exits 2; a PV
table disjoint from the cache gives null statistics; ``doctor`` reports
the runtime and exits 1 without a card; the flags of slices not yet ported
(and the JAX package's own, such as ``analyze --tier jaxpr``) are rejected
by argparse; ``analyze`` exits 0 on the repo and 1 with the fixtures'
findings, as the JAX CLI's does. ``compute --backend numpy`` gives the JAX CLI's
numbers bitwise, ``--backend polars`` with no reference tree fails as
the JAX CLI does (before any day, no cache), and
``compute --profile-dir``/the bare ``--telemetry-dir --profile-dir`` demo
leave a trace whose summary the attribution report embeds.
"""

import json
import os

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.__main__ import (
    main as jax_main)
from replication_of_minute_frequency_factor_tpu_torch.__main__ import main
from test_cli import workspace  # noqa: F401 — the shared fixture

STATS = ("IC", "ICIR", "rank_IC", "rank_ICIR")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both(capsys, argv, cache):
    """(port JSON, JAX JSON) of one command; each package keeps its own
    cache, ``<cache>.port`` or ``<cache>.jax``, where argv says CACHE."""
    out = []
    for fn, extra, tag in ((main, ["--device", "cpu"], "port"),
                           (jax_main, [], "jax")):
        args = [f"{cache}.{tag}" if a == "CACHE" else a for a in argv]
        assert fn(args + extra) == 0
        out.append(_last_json(capsys))
    return out


def test_compute_then_evaluate_matches_jax(workspace, capsys):
    kline, pv, cache, tmp = workspace
    port, ref = _both(capsys, [
        "compute", "--minute-dir", kline, "--cache", "CACHE",
        "--factors", "vol_return1min,mmt_ols_qrs,mmt_pm",
        "--days-per-batch", "3", "--quiet"], cache)
    assert port.keys() == ref.keys()
    assert {k: port[k] for k in port if k != "cache"} \
        == {k: ref[k] for k in ref if k != "cache"}
    assert port["days"] == 8 and port["factors"] == 3
    assert os.path.exists(cache + ".port")
    for factor in ("vol_return1min", "mmt_ols_qrs"):
        for extra in ([], ["--weight", "cmc", "--group-num", "3"]):
            port, ref = _both(capsys, [
                "evaluate", "--factor", factor, "--cache", "CACHE",
                "--daily-pv", pv, "--future-days", "1",
                "--frequency", "week", *extra], cache)
            assert port.keys() == ref.keys()
            assert port["factor"] == ref["factor"] == factor
            for k in STATS:
                assert np.isfinite(port[k]), k
                np.testing.assert_allclose(port[k], ref[k], rtol=1e-4,
                                           atol=2e-6, err_msg=k)


def test_evaluate_writes_the_three_charts(workspace, capsys):
    kline, pv, cache, tmp = workspace
    assert main(["compute", "--minute-dir", kline, "--cache", cache,
                 "--factors", "vol_return1min", "--quiet",
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    plots = os.path.join(tmp, "charts")
    assert main(["evaluate", "--factor", "vol_return1min", "--cache", cache,
                 "--daily-pv", pv, "--future-days", "1", "--frequency",
                 "week", "--plots", plots, "--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert out["plots_written"] == ["coverage", "ic", "group"]
    for kind in ("coverage", "ic", "group"):
        assert os.path.getsize(
            os.path.join(plots, f"vol_return1min_{kind}.png")) > 5_000
    # unknown factor: clean error, not a traceback
    assert main(["evaluate", "--factor", "nope", "--cache", cache,
                 "--daily-pv", pv, "--device", "cpu"]) == 2


@pytest.mark.parametrize("as_json", [False, True])
def test_list_factors_identical(capsys, as_json):
    argv = ["list-factors"] + (["--json"] if as_json else [])
    assert main(argv) == 0
    port = capsys.readouterr().out
    assert jax_main(argv) == 0
    assert port == capsys.readouterr().out
    assert "total: 58" in port or len(json.loads(port)) == 58


def test_compute_rejects_unknown_factor(workspace, capsys):
    kline, _, cache, _ = workspace
    rc = main(["compute", "--minute-dir", kline, "--cache", cache,
               "--factors", "vol_return1mim", "--quiet", "--device", "cpu"])
    assert rc == 2
    assert not os.path.exists(cache)
    assert "vol_return1mim" in capsys.readouterr().err


def test_evaluate_disjoint_pv_reports_null_stats(workspace, capsys,
                                                 tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    kline, pv, cache, tmp = workspace
    assert main(["compute", "--minute-dir", kline, "--cache", cache,
                 "--factors", "mmt_pm", "--quiet", "--device", "cpu"]) == 0
    capsys.readouterr()
    other = str(tmp_path / "pv_other.parquet")
    dd = np.array(["2030-01-02", "2030-01-03"], dtype="datetime64[D]")
    pq.write_table(pa.table({
        "code": pa.array(["999999"] * 2), "date": pa.array(dd),
        "pct_change": pa.array([0.01, -0.01]),
        "tmc": pa.array([1e9, 1e9]), "cmc": pa.array([7e8, 7e8]),
    }), other)
    assert main(["evaluate", "--factor", "mmt_pm", "--cache", cache,
                 "--daily-pv", other, "--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert out == {"factor": "mmt_pm", "IC": None, "ICIR": None,
                   "rank_IC": None, "rank_ICIR": None}


def test_doctor_reports_the_runtime(capsys):
    rc = main(["doctor"])
    out = json.loads(capsys.readouterr().out)
    assert out["torch"] == torch.__version__
    assert out["cuda_available"] == torch.cuda.is_available()
    assert (rc == 0) == out["cuda_available"]
    assert out["kernel_build_dir"].endswith(os.path.join("build",
                                                         "kernels"))
    assert set(out["kernels_built"]) == {"rolling_moments", "pv_corr"}
    assert "nvcc" in out
    assert out["native_encoder"].startswith(("built", "unavailable"))
    assert "days_per_batch" in out["config"]
    assert "daily_pv_path" in out["config"]


def test_the_cli_refuses_the_cpu_unless_asked(workspace, capsys,
                                              monkeypatch):
    kline, pv, cache, _ = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["compute", "--minute-dir", kline, "--cache", cache,
              "--factors", "mmt_pm", "--quiet"])
    assert main(["compute", "--minute-dir", kline, "--cache", cache,
                 "--factors", "mmt_pm", "--quiet", "--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["evaluate", "--factor", "mmt_pm", "--cache", cache,
              "--daily-pv", pv, "--device", "cuda"])


@pytest.mark.parametrize("argv", [
    ["compute", "--minute-dir", "d", "--cache", "c", "--backend", "jax"],
    ["compute", "--minute-dir", "d", "--cache", "c", "--mesh-tickers", "x"],
    ["compute", "--minute-dir", "d", "--cache", "c", "--profile-dir"],
    ["--profile-dir", "p"],
    ["compute", "--minute-dir", "d", "--cache", "c", "--rolling-impl",
     "pallas"],
    ["serve", "--demo", "1", "--backend", "numpy"],
    ["serve", "--demo", "1", "--profile-dir", "p"],
    ["analyze", "--tier", "jaxpr"],
    [],
])
def test_unported_flags_and_subcommands_are_rejected(argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2


def test_serve_fleet_and_research_exit_2_naming_the_roadmap(capsys):
    """``serve --fleet N`` and ``serve --research`` are both ported: they
    no longer exit 2. The fleet's demo routes through two replicas on
    the CPU (held to the JAX CLI by tests/test_torch_fleet.py), and a
    research server answers the demo."""
    assert main(["serve", "--fleet", "2", "--device", "cpu", "--demo", "3",
                 "--synthetic-days", "4", "--synthetic-tickers", "8",
                 "--factors", "vol_return1min"]) == 0
    out = _last_json(capsys)
    assert (out["fleet"], out["live_replicas"], out["routed"]) == (2, 2, 3)
    assert main(["serve", "--research", "--demo", "1", "--device", "cpu",
                 "--synthetic-days", "4", "--synthetic-tickers", "8",
                 "--factors", "vol_return1min"]) == 0
    assert _last_json(capsys)["demo_requests"] == 1


def test_compute_telemetry_dir_writes_the_bundle(workspace, capsys):
    """``compute --telemetry-dir DIR`` writes the JAX package's bundle
    (manifest, metrics stream, trace) plus attribution.json, and the JAX
    package's validator accepts it."""
    from replication_of_minute_frequency_factor_tpu.telemetry.validate import (
        validate_dir)
    kline, _pv, cache, tmp = workspace
    out_dir = os.path.join(str(tmp), "tel")
    assert main(["compute", "--minute-dir", kline, "--cache", cache,
                 "--factors", "mmt_am", "--quiet", "--device", "cpu",
                 "--telemetry-dir", out_dir]) == 0
    out = _last_json(capsys)
    assert set(out["telemetry"]) == {"manifest", "metrics", "trace",
                                     "attribution"}
    assert sorted(os.listdir(out_dir)) == [
        "attribution.json", "manifest.json", "metrics.jsonl", "trace.json"]
    assert validate_dir(out_dir)["ok"]
    with open(os.path.join(out_dir, "manifest.json")) as fh:
        assert json.load(fh)["run_kind"] == "compute"


def test_compute_backend_numpy_matches_the_jax_cli(workspace, capsys):
    """``compute --backend numpy`` through both CLIs: the same summary and
    the same cache, bit for bit."""
    from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
        ExposureTable)
    kline, _pv, cache, _tmp = workspace
    port, ref = _both(capsys, [
        "compute", "--minute-dir", kline, "--cache", "CACHE", "--factors",
        "vol_return1min,mmt_ols_qrs,doc_pdf80", "--backend", "numpy",
        "--quiet"], cache)
    assert {k: port[k] for k in port if k != "cache"} \
        == {k: ref[k] for k in ref if k != "cache"}
    a = ExposureTable.load(cache + ".port")
    b = ExposureTable.load(cache + ".jax")
    assert list(a.columns) == list(b.columns)
    for k in a.factor_names:
        np.testing.assert_array_equal(a.columns[k].view(np.int32),
                                      b.columns[k].view(np.int32), err_msg=k)


def test_compute_mesh_tickers_matches_the_jax_cli(workspace, capsys):
    """``compute --mesh-tickers 2`` spawns two gloo ranks: the same summary
    as the JAX CLI's sharded run, and a cache bitwise the port's
    single-device cache; ``--telemetry-dir`` with spawned ranks and
    ``N < 1`` exit 2."""
    from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
        ExposureTable)
    kline, _pv, cache, _tmp = workspace
    argv = ["compute", "--minute-dir", kline, "--cache", "CACHE",
            "--factors", "vol_return1min,mmt_ols_qrs,doc_pdf80", "--quiet",
            "--days-per-batch", "4"]
    port, ref = _both(capsys, argv + ["--mesh-tickers", "2"], cache)
    assert {k: port[k] for k in port if k != "cache"} \
        == {k: ref[k] for k in ref if k != "cache"}
    assert main([a if a != "CACHE" else cache + ".one" for a in argv]
                + ["--device", "cpu"]) == 0
    a = ExposureTable.load(cache + ".port")
    b = ExposureTable.load(cache + ".one")
    assert list(a.columns) == list(b.columns) and len(a) == len(b) > 0
    for k in a.columns:
        got, want = np.asarray(a.columns[k]), np.asarray(b.columns[k])
        if got.dtype == np.float32:
            got, want = got.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=k)
    capsys.readouterr()
    for extra in (["--mesh-tickers", "0"],
                  ["--mesh-tickers", "2", "--telemetry-dir", _tmp]):
        assert main([a if a != "CACHE" else cache + ".x" for a in argv]
                    + extra + ["--device", "cpu"]) == 2


def test_compute_backend_polars_exits_2_with_the_reason(workspace,
                                                       monkeypatch):
    """``--backend polars`` runs now (tests/test_torch_refdiff.py holds its
    output); with no reference tree it fails as the JAX CLI does: the
    harness's FileNotFoundError naming the missing file propagates out of
    ``main`` (exit 1 with its traceback as a command), before any day is
    read, and neither CLI writes a cache."""
    from replication_of_minute_frequency_factor_tpu_torch.refdiff import (
        harness)
    from tools.refdiff import harness as jax_harness

    kline, _pv, cache, tmp = workspace
    for h in (harness, jax_harness):
        monkeypatch.setattr(h, "REFERENCE_DIR",
                            os.path.join(str(tmp), "no_tree"))
        monkeypatch.setattr(h, "_ref_kernels_mod", None)
    argv = ["compute", "--minute-dir", kline, "--backend", "polars"]
    with pytest.raises(FileNotFoundError, match="no_tree") as port:
        main(argv + ["--cache", cache, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no_tree") as ref:
        jax_main(argv + ["--cache", cache + ".jax"])
    assert str(port.value) == str(ref.value)
    assert not os.path.exists(cache) and not os.path.exists(cache + ".jax")


def test_compute_profile_dir_writes_a_trace_the_report_reads(workspace,
                                                            capsys):
    """``compute --profile-dir P --telemetry-dir T``: a torch.profiler
    trace in P, the bundle in T (the JAX validator accepts it), and
    attribution.json's ``trace`` block the summary of P, with the
    driver's stages among its annotations."""
    from replication_of_minute_frequency_factor_tpu.telemetry.validate import (
        validate_dir)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        attribution)
    kline, _pv, cache, tmp = workspace
    prof, tel = os.path.join(str(tmp), "prof"), os.path.join(str(tmp), "tel")
    assert main(["compute", "--minute-dir", kline, "--cache", cache,
                 "--factors", "mmt_am", "--quiet", "--device", "cpu",
                 "--profile-dir", prof, "--telemetry-dir", tel]) == 0
    assert _last_json(capsys)["days"] == 8
    files = attribution.find_trace_files(prof)
    assert len(files) == 1 and files[0].endswith(".trace.json")
    assert validate_dir(tel)["ok"]
    with open(os.path.join(tel, "attribution.json")) as fh:
        report = json.load(fh)
    assert report["trace"]["files"] == 1
    assert {"io", "grid", "launch", "device"} <= set(
        report["trace"]["stage_annotations_us"])
    assert report["trace"]["device_breakdown"]["device_events"] == 0
    assert "trace_capture" in report["reconciliation"]["stages"]


def test_bare_telemetry_dir_with_profile_dir_embeds_the_trace(tmp_path,
                                                              capsys):
    """The synthetic demo under a capture, as the JAX CLI's: the report
    embeds the trace summary and the bundle validates with both
    packages' validators."""
    from replication_of_minute_frequency_factor_tpu.telemetry.validate import (
        validate_dir as jax_validate_dir)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry.validate import (
        validate_dir)
    tel, prof = str(tmp_path / "tel"), str(tmp_path / "prof")
    assert main(["--telemetry-dir", tel, "--profile-dir", prof,
                 "--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert out["reconciliation_ok"]
    with open(out["telemetry"]["attribution"]) as fh:
        report = json.load(fh)
    assert report["trace"]["files"] == 1
    assert report["trace"]["profile_dir"] == prof
    assert validate_dir(tel)["ok"] and jax_validate_dir(tel)["ok"]


def test_analyze_is_clean_on_the_repo_and_flags_the_fixtures(
        tmp_path, capsys):
    """``analyze``: exit 0 on the repo against the committed baseline
    (every tier, the trace on the CPU), exit 1 with the new findings on
    the torch fixtures, whose count per rule is the JAX CLI's on its
    fixtures (GL-A1 apart: its truth is the installed framework)."""
    report = str(tmp_path / "r.json")
    assert main(["analyze", "--device", "cpu", "--report", report]) == 0
    out = _last_json(capsys)
    assert out["ok"] is True and out["kernels"] == 58
    assert out["tier"] == "all" and out["new"] == 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixtures = os.path.join(repo, "tests", "fixtures", "graftlint_torch")
    args = ["--tier", "ast", "--paths", fixtures, "--report", "-",
            "--baseline", str(tmp_path / "none.json")]
    assert main(["analyze", *args]) == 1
    out = _last_json(capsys)
    assert out["ok"] is False and out["new"] == 36
    jargs = ["--tier", "ast", "--paths",
             os.path.join(repo, "tests", "fixtures", "graftlint"),
             "--report", "-", "--baseline", str(tmp_path / "none.json")]
    assert jax_main(["analyze", *jargs]) == 1
    jout = _last_json(capsys)
    want = {k: v for k, v in jout["by_rule"].items() if k != "GL-A1"}
    assert {k: v for k, v in out["by_rule"].items() if k != "GL-A1"} == want
    assert out["by_rule"]["GL-A1"] == 2
