"""The port's refdiff copy (``refdiff/``) and its ``backend='polars'``.

1. The shim copy: a table of polars expression programs over seeded frames
   with nulls, NaNs, empty groups and groups of ``n <= ddof`` runs through
   the port's shim and through tools/refdiff/polars_shim.py; the values
   and validity masks must be equal bit for bit, and so must
   ``SEMANTIC_PINS``.
2. A stand-in reference tree (tests/fixtures/refdiff_torch/: the snapshot's
   three factors in the shim's polars subset, transcribed from the port's
   oracle) with each harness pointed at it: the JAX package's
   ``compute_exposures(backend='polars')`` and the port's are equal bit for
   bit, the port's equals its numpy backend at tests/test_pipeline.py's
   tolerances, and the CLI's ``compute --backend polars`` writes the same
   cache in both packages.
3. The fail-closed paths, the same in both packages: the pin, a missing
   tree (raised before any day is read, no cache), a real ``polars`` never
   replaced, ``sys.modules`` restored after an exec, a raising day
   isolated into ``failures``.
4. The reference-tree differentials of tests/test_refdiff.py on the port's
   harness, skipped as that file skips them when the tree is not mounted.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import sys
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from replication_of_minute_frequency_factor_tpu import pipeline as jax_pipeline
from replication_of_minute_frequency_factor_tpu.__main__ import (
    main as jax_main)
from replication_of_minute_frequency_factor_tpu.config import Config as JConfig
from replication_of_minute_frequency_factor_tpu.data.synthetic import (
    synth_day)
from replication_of_minute_frequency_factor_tpu_torch import pipeline
from replication_of_minute_frequency_factor_tpu_torch.__main__ import (
    main as port_main)
from replication_of_minute_frequency_factor_tpu_torch.config import Config
from replication_of_minute_frequency_factor_tpu_torch.refdiff import (
    harness as port_harness)
from replication_of_minute_frequency_factor_tpu_torch.refdiff import (
    polars_shim as port_shim)
from test_pipeline import minute_dir  # noqa: F401 — the shared fixture
from tools.refdiff import harness as jax_harness
from tools.refdiff import polars_shim as jax_shim

HERE = os.path.dirname(os.path.abspath(__file__))
STAND_IN = os.path.join(HERE, "fixtures", "refdiff_torch")
NAMES = ["vol_return1min", "mmt_pm", "doc_pdf60"]
HARNESSES = {"jax": jax_harness, "port": port_harness}


# --------------------------------------------------------------------------
# 1. the shim copy
# --------------------------------------------------------------------------


def _frame(pl, seed):
    """Rows sorted by (code, t): codes A-D, a singleton S (n <= ddof) and
    E whose y is all null; x holds NaNs and nulls, y nulls."""
    rng = np.random.default_rng(seed)
    code = np.sort(np.r_[np.array(list("ABCD"))[rng.integers(0, 4, 80)],
                         ["S"], ["E"] * 5]).astype(object)
    n = code.size
    t = np.zeros(n, np.int64)
    for c in np.unique(code):
        sel = code == c
        t[sel] = np.cumsum(rng.integers(1, 3, sel.sum()))
    date = (np.datetime64("2024-01-01")
            + rng.integers(0, 70, n)).astype("datetime64[D]")
    x = rng.normal(0.0, 1.0, n)
    x[rng.random(n) < 0.08] = np.nan
    x_ok = rng.random(n) >= 0.1
    y = np.round(rng.normal(0.5, 2.0, n), 3)
    y_ok = (rng.random(n) >= 0.15) & (code != "E")
    v = rng.integers(0, 50, n).astype(np.int64)
    return pl.DataFrame({"code": code, "t": t, "date": date,
                         "x": pl.Series(x, x_ok), "y": pl.Series(y, y_ok),
                         "v": v})


def _aggs(pl):
    c = pl.col
    return [c("x").sum().alias("sum"), c("x").mean().alias("mean"),
            c("x").std().alias("std"), c("x").std(0).alias("std0"),
            c("y").var().alias("var"), c("x").skew().alias("skew"),
            c("y").kurtosis().alias("kurt"), c("x").first().alias("first"),
            c("y").last().alias("last"), c("y").product().alias("prod"),
            c("x").min().alias("min"), c("y").max().alias("max"),
            c("y").count().alias("count"), pl._pl_len().alias("len")]


PROGRAMS = {
    "group_by_agg": lambda pl, f, g: f.group_by("code").agg(_aggs(pl)),
    "group_by_two_keys_n_le_ddof": lambda pl, f, g: f.group_by(
        ["code", "date"]).agg(_aggs(pl)),
    "empty_selections": lambda pl, f, g: f.group_by("code").agg(
        pl.col("x").filter(pl.col("y") > 100).sum().alias("s"),
        pl.col("x").filter(pl.col("y") > 100).mean().alias("m"),
        pl.col("x").filter(pl.col("y") > 100).std().alias("sd"),
        pl.col("x").filter(pl.col("y") > 100).first().alias("f"),
        pl.col("y").filter(pl.col("y") > 100).product().alias("p")),
    "corr_cov": lambda pl, f, g: f.group_by("code").agg(
        pl.corr("x", "y").alias("r"), pl.cov("x", "y").alias("cv"),
        pl.corr("x", "y", method="spearman").alias("rs")),
    "over": lambda pl, f, g: f.with_columns(
        (pl.col("x") - pl.col("x").mean().over("code")).alias("dm"),
        pl.col("y").sum().over(["code", "date"]).alias("s"),
        pl.col("y").last().over("code").alias("l")),
    "rolling": lambda pl, f, g: f.rolling(
        index_column="t", period="5i", group_by="code").agg(
        pl.col("x").mean().alias("m"), pl.col("y").std().alias("s"),
        pl.col("y").sum().alias("sum")),
    "group_by_dynamic_week": lambda pl, f, g: f.sort(["code", "date"])
    .group_by_dynamic("date", every="1w", group_by="code").agg(
        pl.col("x").last().alias("l"), pl.col("y").sum().alias("s")),
    "group_by_dynamic_month_right": lambda pl, f, g: f.sort("date")
    .select("date", "y").group_by_dynamic(every="1mo", label="right")
    .agg(pl.col("y").mean().alias("m"), pl.col("y").std().alias("s")),
    "when_then": lambda pl, f, g: f.with_columns(
        pl.when(pl.col("x") > 0).then(pl.col("y"))
        .when(pl.col("x").is_null()).then(pl.lit(-1.0))
        .otherwise(pl.col("x")).alias("w")),
    "cum_sum": lambda pl, f, g: f.with_columns(
        pl.col("y").cum_sum().alias("cs"),
        pl.col("y").cum_sum().over("code").alias("csg"),
        pl.col("v").cum_prod().alias("cp")),
    "rank": lambda pl, f, g: f.with_columns(
        pl.col("x").rank().alias("r"),
        pl.col("y").rank().over("code").alias("rg")),
    "top_k": lambda pl, f, g: f.group_by("code").agg(
        pl.col("x").top_k(3).sum().alias("top"),
        pl.col("y").bottom_k(2).mean().alias("bot")),
    "joins": lambda pl, f, g: [
        f.join(g, on="code", how="left"),
        f.join(g, on=["code"], how="inner")],
    "concat": lambda pl, f, g: [
        pl.concat([f, f]),
        pl.concat([f.select("code", "date", "x"),
                   f.group_by(["code", "date"]).agg(
                       pl.col("y").sum().alias("ys"))], how="align_left")],
    "elementwise": lambda pl, f, g: f.with_columns(
        pl.col("y").pct_change().alias("pc"),
        pl.col("x").shift(2).alias("sh"),
        pl.col("x").fill_null(0.0).alias("fn"),
        pl.col("x").is_null().alias("isnull"),
        pl.col("x").is_nan().alias("isnan"),
        pl.col("y").abs().log().alias("lg"),
        pl.col("y").exp().alias("ex"),
        pl.col("y").cast(pl.Int64).alias("ci"),
        (pl.col("v") / pl.col("t")).alias("div"),
        (pl.col("y") ** 2).alias("sq"),
        pl.col("code").is_in(["A", "S"]).alias("isin")),
    "qcut": lambda pl, f, g: f.with_columns(
        pl.col("y").qcut(4, allow_duplicates=True).alias("q")),
    "sort_with_nulls": lambda pl, f, g: [
        f.sort(["code", "y"]), f.sort("t", descending=True)],
    "select_filter": lambda pl, f, g: f.filter(pl.col("y") > 0).select(
        "code", (pl.col("x") * 2).alias("x2")),
}


def _other(pl, seed):
    rng = np.random.default_rng(seed)
    return pl.DataFrame({"code": np.array(["A", "B", "B", "Z"], object),
                         "w": pl.Series(rng.normal(size=4),
                                        np.array([1, 1, 0, 1], bool))})


def _cells(out):
    """A program's output as comparable bytes: every column's dtype, value
    bytes and validity mask, in order."""
    if isinstance(out, list):
        return [_cells(o) for o in out]
    if hasattr(out, "_cols"):
        return [out.height] + [(k, _cells(s)) for k, s in out._cols.items()]
    v, ok = np.asarray(out.v), np.asarray(out.ok)
    if v.dtype.kind == "O":
        return (str(v.dtype), [repr(x) for x in v.tolist()], ok.tobytes())
    return (v.dtype.str, v.tobytes(), ok.tobytes())


def _run(shim, name, seed):
    pl = types.SimpleNamespace(**{k: getattr(shim, k) for k in dir(shim)})
    return _cells(PROGRAMS[name](pl, _frame(shim, seed),
                                 _other(shim, seed)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_shim_copy_is_the_tools_shim_bitwise(name, seed):
    got, want = _run(port_shim, name, seed), _run(jax_shim, name, seed)
    assert got == want


def test_shim_copy_reads_parquet_like_the_tools_shim(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({
        "code": pa.array(["a", None, "c"], pa.string()),
        "d": pa.array([np.datetime64("2024-01-02", "D").item(), None,
                       np.datetime64("2024-02-03", "D").item()],
                      pa.date32()),
        "x": pa.array([1.5, None, float("nan")]),
        "n": pa.array([1, 2, None], pa.int64())}), path)
    got = _cells(port_shim.read_parquet(path))
    assert got == _cells(jax_shim.read_parquet(path))
    frame = port_shim.read_parquet(path)
    frame.write_parquet(str(tmp_path / "u.parquet"))
    assert _cells(port_shim.read_parquet(str(tmp_path / "u.parquet"))) \
        == _cells(jax_shim.read_parquet(str(tmp_path / "u.parquet")))


def test_semantic_pins_and_readings_are_the_tools_shims():
    assert port_shim.SEMANTIC_PINS == jax_shim.SEMANTIC_PINS
    for pin in ("constant_window", "qcut_nan"):
        assert port_shim._pin_reading(pin) == jax_shim._pin_reading(pin)
    with port_shim.pin_reading(constant_window="noise"):
        assert port_shim._pin_reading("constant_window") == "noise"
    assert port_shim._pin_reading("constant_window") == "degenerate"


def test_harness_pins_and_tolerances_are_the_tools_harness():
    for k in ("_REFERENCE_SHA256", "_KERNELS", "RTOL_DEFAULT",
              "ATOL_DEFAULT", "RTOL", "ATOL", "_FREQ_REF_TO_REPO",
              "_EVERY"):
        assert getattr(port_harness, k) == getattr(jax_harness, k), k
    assert port_harness.REFERENCE_DIR == jax_harness.REFERENCE_DIR


# --------------------------------------------------------------------------
# 2. the stand-in reference tree
# --------------------------------------------------------------------------


@pytest.fixture
def stand_in(monkeypatch):
    """Both harnesses pointed at the stand-in tree, their cached modules
    cleared, ``REFDIFF_ALLOW_UNPINNED=1``; everything restored after."""
    _point_at(monkeypatch, STAND_IN)
    monkeypatch.setenv("REFDIFF_ALLOW_UNPINNED", "1")
    return STAND_IN


def _point_at(monkeypatch, tree):
    for h in HARNESSES.values():
        monkeypatch.setattr(h, "REFERENCE_DIR", str(tree))
        monkeypatch.setattr(h, "_ref_kernels_mod", None)


def _tables_equal_bitwise(a, b, names):
    assert len(a) == len(b) > 0
    for k in ("code", "date"):
        np.testing.assert_array_equal(np.asarray(a.columns[k]).astype(str),
                                      np.asarray(b.columns[k]).astype(str))
    for n in names:
        assert a.columns[n].dtype == b.columns[n].dtype == np.float32
        np.testing.assert_array_equal(a.columns[n].view(np.int32),
                                      b.columns[n].view(np.int32),
                                      err_msg=n)


def test_polars_backend_is_the_jax_packages_bitwise(stand_in, minute_dir,
                                                    tmp_path):
    """The same shim in f64, then the same f32 cast: codes, dates and
    values bit for bit."""
    got = pipeline.compute_exposures(
        minute_dir, NAMES, cache_path=str(tmp_path / "port.parquet"),
        cfg=Config(backend="polars", days_per_batch=2), progress=False,
        device="cpu")
    want = jax_pipeline.compute_exposures(
        minute_dir, NAMES, cache_path=str(tmp_path / "jax.parquet"),
        cfg=JConfig(backend="polars", days_per_batch=2), progress=False)
    assert not got.failures and not want.failures
    _tables_equal_bitwise(got, want, NAMES)
    assert got.columns["doc_pdf60"][np.isfinite(
        got.columns["doc_pdf60"])].size > 0


def test_polars_backend_matches_the_numpy_backend(stand_in, minute_dir,
                                                  tmp_path):
    """tests/test_pipeline.py's polars-vs-numpy bar (rtol 1e-5, atol 1e-7,
    the same NaN pattern) on the port."""
    t_pl = pipeline.compute_exposures(
        minute_dir, NAMES, cache_path=str(tmp_path / "pl.parquet"),
        cfg=Config(backend="polars", days_per_batch=2), progress=False)
    t_np = pipeline.compute_exposures(
        minute_dir, NAMES, cache_path=str(tmp_path / "np.parquet"),
        cfg=Config(backend="numpy", days_per_batch=2), progress=False)
    assert len(t_pl) == len(t_np) == 18
    np.testing.assert_array_equal(t_pl.columns["code"], t_np.columns["code"])
    for n in NAMES:
        a, b = t_pl.columns[n], t_np.columns[n]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=n)
        f = ~np.isnan(a)
        np.testing.assert_allclose(a[f], b[f], rtol=1e-5, atol=1e-7,
                                   err_msg=n)


def _run_main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_compute_backend_polars_writes_the_same_cache(stand_in,
                                                          minute_dir,
                                                          tmp_path):
    from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
        ExposureTable)

    argv = ["compute", "--minute-dir", minute_dir, "--backend", "polars",
            "--factors", ",".join(NAMES), "--days-per-batch", "2",
            "--quiet"]
    rc, out = _run_main(port_main, argv + [
        "--cache", str(tmp_path / "port.parquet"), "--device", "cpu"])
    assert rc == 0 and out["rows"] == 18 and out["failed_days"] == 0
    rc_j, out_j = _run_main(jax_main, argv + [
        "--cache", str(tmp_path / "jax.parquet")])
    assert rc_j == 0 and out_j["rows"] == out["rows"]
    got = ExposureTable.load(str(tmp_path / "port.parquet"))
    want = ExposureTable.load(str(tmp_path / "jax.parquet"))
    assert list(got.columns) == list(want.columns)
    _tables_equal_bitwise(got, want, NAMES)
    direct = pipeline.compute_exposures(
        minute_dir, NAMES, cfg=Config(backend="polars"), progress=False)
    _tables_equal_bitwise(got, direct, NAMES)


# --------------------------------------------------------------------------
# 3. fail-closed paths, the same in both packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", sorted(HARNESSES))
def test_unpinned_file_is_refused_unless_allowed(which, monkeypatch):
    h = HARNESSES[which]
    monkeypatch.setattr(h, "REFERENCE_DIR", STAND_IN)
    monkeypatch.delenv("REFDIFF_ALLOW_UNPINNED", raising=False)
    with pytest.raises(RuntimeError, match="unpinned reference file"):
        h._verified_reference_source(h._KERNELS)
    monkeypatch.setattr(h, "_ref_kernels_mod", None)
    with pytest.raises(RuntimeError, match="REFDIFF_ALLOW_UNPINNED=1"):
        h.load_reference_kernels()
    monkeypatch.setenv("REFDIFF_ALLOW_UNPINNED", "1")
    path, source = h._verified_reference_source(h._KERNELS)
    with open(os.path.join(STAND_IN, h._KERNELS), "rb") as fh:
        assert source == fh.read()
    assert path == os.path.join(STAND_IN, h._KERNELS)
    assert hashlib.sha256(source).hexdigest() \
        not in h._REFERENCE_SHA256.values()


def test_missing_tree_raises_before_the_day_loop(minute_dir, tmp_path,
                                                 monkeypatch):
    """No reference tree: both packages raise the same exception before
    any day is read (``fault_hook`` sees no day), with no cache and no
    failure ledger written; the CLIs raise it too and write no cache."""
    _point_at(monkeypatch, tmp_path / "no_tree")
    seen = {"jax": [], "port": []}
    errors = {}
    for which, run in (
            ("jax", lambda c, h: jax_pipeline.compute_exposures(
                minute_dir, NAMES, cache_path=c, fault_hook=h,
                cfg=JConfig(backend="polars"), progress=False)),
            ("port", lambda c, h: pipeline.compute_exposures(
                minute_dir, NAMES, cache_path=c, fault_hook=h,
                cfg=Config(backend="polars"), progress=False,
                device="cpu"))):
        cache = str(tmp_path / f"{which}.parquet")
        with pytest.raises(Exception) as exc:
            run(cache, seen[which].append)
        errors[which] = exc.value
        assert not os.path.exists(cache)
        assert not os.path.exists(cache + ".failures.json")
    assert type(errors["port"]) is type(errors["jax"]) is FileNotFoundError
    assert seen == {"jax": [], "port": []}
    argv = ["compute", "--minute-dir", minute_dir, "--backend", "polars",
            "--quiet"]
    for which, main, extra in (("jax", jax_main, []),
                               ("port", port_main, ["--device", "cpu"])):
        cache = str(tmp_path / f"cli_{which}.parquet")
        with pytest.raises(FileNotFoundError, match="no_tree"):
            main(argv + ["--cache", cache] + extra)
        assert not os.path.exists(cache)


@pytest.mark.parametrize("which", sorted(HARNESSES))
def test_install_shim_never_replaces_a_real_polars(which, monkeypatch):
    """A ``polars`` already in ``sys.modules`` that is not the shim wins,
    and an exec leaves it in place."""
    h = HARNESSES[which]
    real = types.ModuleType("polars")
    monkeypatch.setitem(sys.modules, "polars", real)
    monkeypatch.setattr(h, "_shim_proxy", None)
    assert h.install_shim() is real
    monkeypatch.setattr(h, "REFERENCE_DIR", STAND_IN)
    monkeypatch.setattr(h, "_ref_kernels_mod", None)
    monkeypatch.setenv("REFDIFF_ALLOW_UNPINNED", "1")
    mod = h.load_reference_kernels()
    assert mod.pl is real and sys.modules["polars"] is real
    monkeypatch.setattr(h, "_shim_proxy", None)
    monkeypatch.delitem(sys.modules, "polars")
    shim = h.install_shim()
    if importlib.util.find_spec("polars") is None:
        assert shim.__is_refdiff_shim__ and shim.len().alias("n")._name == "n"


@pytest.mark.parametrize("which", sorted(HARNESSES))
def test_sys_modules_restored_after_an_exec(which, stand_in):
    h = HARNESSES[which]
    before = sys.modules.get("polars")
    mod = h.load_reference_kernels()
    assert sorted(n for n in dir(mod) if n.startswith("cal_")) == sorted(
        "cal_" + n for n in NAMES)
    assert sys.modules.get("polars") is before
    if importlib.util.find_spec("polars") is None:
        assert "polars" not in sys.modules
        assert getattr(mod.pl, "__is_refdiff_shim__", False)


def test_a_raising_day_is_isolated_into_failures(tmp_path, monkeypatch,
                                                 minute_dir):
    """A stand-in tree whose ``cal_vol_return1min`` raises on one poisoned
    day: that day lands in ``failures`` in both packages, the other days
    are kept, and the kept rows are equal bit for bit."""
    tree = tmp_path / "raising"
    tree.mkdir()
    with open(os.path.join(STAND_IN, jax_harness._KERNELS)) as fh:
        src = fh.read()
    src = src.replace(
        'def cal_vol_return1min(df):\n',
        'def cal_vol_return1min(df):\n'
        '    if (df["close"].to_numpy() > 1e6).any():\n'
        '        raise ValueError("poisoned day")\n', 1)
    (tree / jax_harness._KERNELS).write_text(src)
    path = os.path.join(minute_dir, "20240103_cleaned.parquet")
    t = pq.read_table(path)
    pq.write_table(t.set_column(t.column_names.index("close"), "close",
                                pa.compute.multiply(t.column("close"),
                                                    1e7)), path)
    _point_at(monkeypatch, tree)
    monkeypatch.setenv("REFDIFF_ALLOW_UNPINNED", "1")
    got = pipeline.compute_exposures(minute_dir, NAMES, progress=False,
                                     cfg=Config(backend="polars"))
    want = jax_pipeline.compute_exposures(minute_dir, NAMES,
                                          progress=False,
                                          cfg=JConfig(backend="polars"))
    for table in (got, want):
        assert list(table.failures.keys()) == ["2024-01-03"]
        assert "poisoned day" in json.dumps(table.failures.summary())
        assert sorted(set(map(str, table.columns["date"]))) == [
            "2024-01-02", "2024-01-04"]
    _tables_equal_bitwise(got, want, NAMES)


def test_backend_polars_needs_no_tools_tree():
    """The backend resolves its harness by a relative import: the module
    it runs is the port's, whatever ``tools`` is loaded."""
    assert pipeline._reference_polars_rows.__module__ == pipeline.__name__
    assert port_harness.__name__.startswith(
        "replication_of_minute_frequency_factor_tpu_torch.refdiff")
    assert port_harness.install_shim.__module__ == port_harness.__name__
    assert not hasattr(pipeline, "POLARS_REFUSAL")


# --------------------------------------------------------------------------
# 4. the reference-tree differentials on the port's harness
# --------------------------------------------------------------------------

reference_mounted = pytest.mark.skipif(
    not os.path.exists(os.path.join(port_harness.REFERENCE_DIR,
                                    port_harness._KERNELS)),
    reason="reference tree not mounted")

SCENARIOS = {
    "clean": dict(n_codes=6),
    "ragged": dict(n_codes=6, missing_prob=0.1),
    "zero_volume": dict(n_codes=6, zero_volume_prob=0.15),
    "constant_price": dict(n_codes=6, constant_price_codes=2),
    "short_days": dict(n_codes=6, short_day_codes=2),
    "everything": dict(n_codes=8, missing_prob=0.07, zero_volume_prob=0.1,
                       constant_price_codes=2, short_day_codes=2),
}


@reference_mounted
@pytest.mark.parametrize("label", sorted(SCENARIOS))
def test_reference_code_matches_the_ports_oracle(label):
    day = synth_day(np.random.default_rng(42), **SCENARIOS[label])
    mismatches = port_harness.compare_day(day)
    assert not mismatches, "\n".join(mismatches[:20])


@reference_mounted
def test_all_58_reference_kernels_are_the_ports():
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        factor_names)
    mod = port_harness.load_reference_kernels()
    assert sorted(n[4:] for n in dir(mod) if n.startswith("cal_")) \
        == sorted(factor_names())


@reference_mounted
def test_reference_exec_is_hash_pinned_on_the_port(tmp_path, monkeypatch):
    src = os.path.join(port_harness.REFERENCE_DIR, "Factor.py")
    tampered = tmp_path / "Factor.py"
    with open(src, "rb") as fh:
        tampered.write_bytes(fh.read() + b"\n# tampered\n")
    monkeypatch.setattr(port_harness, "REFERENCE_DIR", str(tmp_path))
    monkeypatch.delenv("REFDIFF_ALLOW_UNPINNED", raising=False)
    with pytest.raises(RuntimeError, match="unpinned reference file"):
        port_harness._verified_reference_source("Factor.py")
    monkeypatch.setattr(port_harness, "REFERENCE_DIR",
                        os.path.dirname(src))
    _, source = port_harness._verified_reference_source("Factor.py")
    assert (hashlib.sha256(source).hexdigest()
            == port_harness._REFERENCE_SHA256["Factor.py"])


@reference_mounted
@pytest.mark.parametrize("weight_param", [None, "tmc", "cmc"])
def test_reference_eval_matches_the_port(tmp_path, weight_param):
    fails = port_harness.compare_eval(rng_seed=7, weight_param=weight_param,
                                      tmp_dir=str(tmp_path), device="cpu")
    assert not fails, "\n".join(fails[:20])


@reference_mounted
def test_reference_eval_weekly_matches_the_port(tmp_path):
    fails = port_harness.compare_eval(rng_seed=11, frequency="weekly",
                                      weight_param="tmc",
                                      tmp_dir=str(tmp_path), device="cpu")
    assert not fails, "\n".join(fails[:20])


@reference_mounted
def test_reference_final_exposure_matches_the_port():
    try:
        fails = port_harness.compare_final_exposure(rng_seed=5, n_days=50,
                                                    device="cpu")
    except port_harness.RefdiffUnsupported as e:
        pytest.skip(str(e))
    assert not fails, "\n".join(fails[:20])


@reference_mounted
@pytest.mark.parametrize("precompute_days", [0, 3])
def test_reference_pipeline_matches_the_port(tmp_path, precompute_days):
    try:
        fails = port_harness.compare_pipeline(
            str(tmp_path), n_days=5, precompute_days=precompute_days,
            device="cpu")
    except port_harness.RefdiffUnsupported as e:
        pytest.skip(str(e))
    assert not fails, "\n".join(fails[:20])
