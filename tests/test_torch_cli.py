"""The port's command line vs the JAX package's, on the CPU.

tests/test_cli.py's workspace (8 synthetic day files of 8 tickers and a
daily PV parquet over their codes): ``compute`` then ``evaluate`` through
both CLIs, ``--device cpu`` for the port. The JSON lines carry the same
keys; ``compute``'s values are equal, ``evaluate``'s IC statistics within
rtol 1e-4 / atol 1e-6 (plus the 6-decimal rounding both print).
``list-factors`` prints the same text; an unknown factor exits 2; a PV
table disjoint from the cache gives null statistics; ``doctor`` reports
the runtime and exits 1 without a card; the flags of slices not yet ported
are rejected by argparse. ``compute --backend numpy`` gives the JAX CLI's
numbers bitwise, ``--backend polars`` exits 2 with its reason, and
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
    assert set(out["kernels_built"]) == {"rolling_moments"}
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
    ["compute", "--minute-dir", "d", "--cache", "c", "--mesh-tickers", "2"],
    ["compute", "--minute-dir", "d", "--cache", "c", "--profile-dir"],
    ["--profile-dir", "p"],
    ["compute", "--minute-dir", "d", "--cache", "c", "--rolling-impl",
     "pallas"],
    ["serve", "--demo", "1", "--backend", "numpy"],
    ["serve", "--demo", "1", "--profile-dir", "p"],
    ["analyze"],
    [],
])
def test_unported_flags_and_subcommands_are_rejected(argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2


def test_serve_fleet_and_research_exit_2_naming_the_roadmap(capsys):
    """``serve --fleet N>0`` is not ported: it exits 2 and says which
    ROADMAP item it waits for. ``serve --research`` is ported now: it
    no longer exits 2, and a research server answers the demo."""
    assert main(["serve", "--fleet", "2", "--device", "cpu"]) == 2
    assert "ROADMAP Queue 1 item 7" in capsys.readouterr().err
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


def test_compute_backend_polars_exits_2_with_the_reason(workspace, capsys):
    kline, _pv, cache, _tmp = workspace
    assert main(["compute", "--minute-dir", kline, "--cache", cache,
                 "--backend", "polars", "--device", "cpu"]) == 2
    assert "imports the JAX package" in capsys.readouterr().err
    assert not os.path.exists(cache)


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
