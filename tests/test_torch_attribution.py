"""The port's attribution layer (telemetry/attribution.py) on the CPU:
crash-safe ``torch.profiler`` capture, trace post-processing and
wall-clock reconciliation.

Every test of tests/test_attribution.py but the three of XLA compile
telemetry (which has no torch counterpart), against the port: the
reconciliation, ``classify_op``'s precedence, the synthetic trace
fixture's breakdown and annotations, gz loading, unreadable files, the
capture's contract and the driver's integration. Then what is the port's
own: the JAX package's post-processing on the same fixtures gives the
same summary; the names CUDA and ATen put in a torch trace classify as
the docstring says; a torch trace's device work is selected by category;
a real CPU capture through ``TraceCapture`` (non-empty, stopped on a body
exception, a no-op without a directory, its own cost attributed, a nested
capture counted as a start failure, ``device_time_block`` unavailable).
"""

import gzip
import json
import os
import shutil

import pytest
import torch

from replication_of_minute_frequency_factor_tpu.telemetry import (
    attribution as jax_attr)
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.config import Config
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    attribution as attr)
from test_attribution import FIXTURE, NAMES, _write_days

FIXTURES = os.path.dirname(FIXTURE)


def compute_exposures(*args, **kw):
    return pl.compute_exposures(*args, device="cpu", progress=False, **kw)


# --------------------------------------------------------------------------
# reconcile
# --------------------------------------------------------------------------


def test_reconcile_fully_attributed_is_ok():
    block = attr.reconcile(10.0, {"io": 4.0, "device": 6.0})
    assert block["ok"]
    assert block["unattributed_s"] == 0.0
    assert block["attributed_s"] == 10.0


def test_reconcile_flags_large_unattributed_residual():
    block = attr.reconcile(10.0, {"io": 4.0})
    assert not block["ok"]
    assert block["unattributed_s"] == 6.0
    assert block["unattributed_frac"] == 0.6
    with pytest.raises(attr.ReconciliationError):
        attr.reconcile(10.0, {"io": 4.0}, strict=True)


def test_reconcile_overlap_is_reported_not_flagged():
    block = attr.reconcile(10.0, {"io": 8.0, "device": 7.0})
    assert block["ok"]
    assert block["overlap_s"] == 5.0
    assert block["unattributed_s"] == 0.0


def test_reconcile_absolute_floor_tolerates_microruns():
    assert attr.reconcile(0.010, {"io": 0.005})["ok"]
    assert not attr.reconcile(10.0, {"io": 5.0})["ok"]


def test_reconcile_drops_non_second_entries():
    block = attr.reconcile(1.0, {"io": 1.0, "ingest_MB": 500.0,
                                 "dispatch_floor_ms": 3.0, "ok": True})
    assert set(block["stages"]) == {"io"}
    assert block["ok"]


# --------------------------------------------------------------------------
# trace post-processing
# --------------------------------------------------------------------------


def test_classify_op_precedence():
    assert attr.classify_op("all-reduce.3") == "collective"
    assert attr.classify_op("fusion.123") == "fusion"
    assert attr.classify_op("copy-start.2") == "infeed_outfeed"
    assert attr.classify_op("copy.9") == "data_movement"
    assert attr.classify_op("dynamic-update-slice.1") == "data_movement"
    assert attr.classify_op("dot.5") == "matmul_conv"
    assert attr.classify_op("frobnicate") == "other"


def test_fixture_breakdown_per_op_class():
    events, procs = attr.load_trace_events(FIXTURE)
    assert procs == {1: "/device:TPU:0", 2: "/host:CPU"}
    bd = attr.device_op_breakdown(events, procs)
    assert bd["device_pids"] == ["/device:TPU:0"]
    assert bd["total_device_us"] == pytest.approx(255.0)
    assert bd["by_class_us"] == pytest.approx({
        "fusion": 150.0, "data_movement": 40.0, "collective": 20.0,
        "matmul_conv": 40.0, "other": 5.0})
    top = {row["op"]: row["us"] for row in bd["top_ops_us"]}
    assert top["fusion"] == pytest.approx(150.0)


def test_fixture_stage_annotations():
    events, _ = attr.load_trace_events(FIXTURE)
    totals = attr.stage_annotation_totals(events)
    assert totals == {"grid": 500.0, "factor_batch": 300.0}


def test_load_trace_events_gz_and_summarize(tmp_path):
    with open(FIXTURE) as fh:
        doc = fh.read()
    gz = tmp_path / "cap" / "host.trace.json.gz"
    gz.parent.mkdir()
    with gzip.open(gz, "wt") as fh:
        fh.write(doc)
    summary = attr.summarize_trace_dir(str(tmp_path / "cap"))
    assert summary["files"] == 1
    assert summary["events"] == 12
    assert summary["device_breakdown"]["total_device_us"] == \
        pytest.approx(255.0)


def test_unreadable_trace_file_is_empty_not_fatal(tmp_path):
    bad = tmp_path / "bad.trace.json"
    bad.write_text("{not json")
    events, procs = attr.load_trace_events(str(bad))
    assert events == [] and procs == {}


def test_build_report_embeds_trace_summary(tmp_path):
    cap = tmp_path / "cap"
    cap.mkdir()
    shutil.copy(FIXTURE, cap / "x.trace.json")
    report = attr.build_report({"io": 1.0, "device": 8.5}, wall_s=10.0,
                               profile_dir=str(cap))
    assert report["schema"] == attr.REPORT_SCHEMA
    assert report["reconciliation"]["ok"]
    assert report["trace"]["files"] == 1
    assert report["trace"]["device_breakdown"]["by_class_us"]["fusion"] \
        == pytest.approx(150.0)
    out = attr.write_report(str(tmp_path / "attribution.json"), report)
    with open(out) as fh:
        assert json.load(fh)["reconciliation"]["ok"]


@pytest.mark.parametrize("fixture", ["synthetic", "collectives"])
def test_summaries_equal_the_jax_packages(fixture, tmp_path):
    """On the JAX package's own traces the port's post-processing gives
    the JAX package's summary and device-time block, key for key."""
    src = (FIXTURE if fixture == "synthetic"
           else os.path.join(FIXTURES, "trace_collectives"))
    cap = tmp_path / "cap"
    if os.path.isdir(src):
        shutil.copytree(src, cap)
    else:
        cap.mkdir()
        shutil.copy(src, cap / "x.trace.json")
    want = jax_attr.summarize_trace_dir(str(cap))
    assert attr.summarize_trace_dir(str(cap)) == want
    assert attr.device_time_block(str(cap)) == \
        jax_attr.device_time_block(str(cap))
    assert attr.reconcile(3.0, {"io": 1.0}, strict=False) == \
        jax_attr.reconcile(3.0, {"io": 1.0})


def test_collective_breakdown_classifies_the_fixture():
    s = attr.summarize_trace_dir(os.path.join(FIXTURES, "trace_collectives"))
    cb = s["collective_breakdown"]
    assert cb["collective_events"] == 4
    assert cb["total_collective_us"] == 230.0
    assert cb["by_kind_us"] == {"all_gather": 120.0, "all_reduce": 80.0,
                                "collective_permute": 30.0}


def test_device_time_block_embeds_collective_seconds():
    tel = Telemetry(annotate_spans=False)
    block = attr.device_time_block(
        os.path.join(FIXTURES, "trace_collectives"), telemetry=tel)
    assert block["available"]
    assert block["device_time_s"] == 680e-6
    assert block["collective_time_s"] == 230e-6
    g = tel.registry.snapshot()["gauges"]
    assert g["device.collective_time_s{op=all_gather}"] == 120e-6
    assert g["device.device_time_s{class=fusion}"] == 400e-6


#: kernel names from a torch.profiler capture on an H100
#: (fixtures/cuda_kernel_names.json says which), each with its class
with open(os.path.join(FIXTURES, "cuda_kernel_names.json")) as _fh:
    CARD_NAMES = tuple((r["name"], r["class"])
                       for r in json.load(_fh)["names"])
#: the classes no single-card factor run puts in a trace: the other
#: copies, a cuBLAS product, an NCCL collective
CUDA_NAMES = CARD_NAMES + (
    ("Memcpy HtoD (Pinned -> Device)", "infeed_outfeed"),
    ("Memcpy DtoH (Device -> Pinned)", "infeed_outfeed"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
     "matmul_conv"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "collective"),
)
TILED = ("void (anonymous namespace)::second_moments_tiled_kernel<50, 4, "
         "4>((anonymous namespace)::TiledArgs)")


def test_the_card_capture_covers_each_kind_of_kernel():
    classes = {c for _, c in CARD_NAMES}
    assert classes == {"infeed_outfeed", "data_movement", "fusion",
                       "reduction", "sort_scan", "other"}
    assert (TILED, "other") in CARD_NAMES


@pytest.mark.parametrize("name,cls", CUDA_NAMES,
                         ids=[c + str(i) for i, (_, c) in
                              enumerate(CUDA_NAMES)])
def test_classify_op_on_cuda_and_aten_kernel_names(name, cls):
    assert attr.classify_op(name) == cls


ELEMENTWISE = next(n for n, c in CARD_NAMES if c == "fusion")


def _torch_style_trace(path):
    """A trace laid out as torch.profiler exports one on a card: host ops
    and annotations on the process's pid, kernels and copies by category
    on the device's pids (which torch names after the process, not the
    card), and the device's projection of a host annotation
    (``gpu_user_annotation``) beside them."""
    events = [
        {"ph": "M", "pid": 4242, "name": "process_name",
         "args": {"name": "python"}},
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "pid": 4242, "tid": 1,
         "ts": 0, "dur": 900.0, "name": "launch"},
        {"ph": "X", "cat": "user_annotation", "pid": 4242, "tid": 2,
         "ts": 0, "dur": 300.0, "name": "io"},
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 1, "ts": 1,
         "dur": 50.0, "name": "aten::add"},
        {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 1, "ts": 2,
         "dur": 5.0, "name": "cudaLaunchKernel"},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 10, "dur": 800.0, "name": "launch"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 10,
         "dur": 40.0, "name": ELEMENTWISE},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 60,
         "dur": 120.0, "name": TILED},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 8, "ts": 0,
         "dur": 30.0, "name": "Memcpy HtoD (Pinned -> Device)"},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "ts": 200,
         "dur": 2.0, "name": "Memset (Device)"},
    ]
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)


def test_torch_trace_device_work_is_selected_by_category(tmp_path):
    _torch_style_trace(tmp_path / "card.trace.json")
    s = attr.summarize_trace_dir(str(tmp_path), top_n=None)
    bd = s["device_breakdown"]
    assert bd["device_events"] == 4
    assert bd["total_device_us"] == 192.0
    assert bd["by_class_us"] == {"other": 120.0, "fusion": 40.0,
                                 "infeed_outfeed": 30.0,
                                 "data_movement": 2.0}
    assert bd["top_ops_us"][0] == {"op": TILED, "us": 120.0}
    assert len(bd["top_ops_us"]) == 4
    assert len(attr.summarize_trace_dir(str(tmp_path), top_n=2)
               ["device_breakdown"]["top_ops_us"]) == 2
    # the host's annotations count, not their projection on the card
    assert s["stage_annotations_us"] == {"launch": 900.0, "io": 300.0}
    assert attr.device_time_block(str(tmp_path))["available"] is True


def test_device_time_block_is_explicitly_unavailable_without_device_work(
        tmp_path):
    with open(tmp_path / "hostonly.trace.json", "w") as fh:
        json.dump({"traceEvents": [
            {"ph": "M", "pid": 2, "name": "process_name",
             "args": {"name": "python"}},
            {"ph": "X", "pid": 2, "tid": 1, "ts": 0, "dur": 5.0,
             "name": "all-reduce.1"},
            {"ph": "X", "cat": "cpu_op", "pid": 2, "tid": 1, "ts": 0,
             "dur": 5.0, "name": "aten::add"}]}, fh)
    block = attr.device_time_block(str(tmp_path))
    assert block["available"] is False
    assert block["device_time_s"] == 0.0
    assert block["collective_time_s"] == 0.0


def test_classify_collective_kinds():
    assert attr.classify_collective("all-gather.7") == "all_gather"
    assert attr.classify_collective("psum") == "all_reduce"
    assert attr.classify_collective(
        "collective-permute-start.2") == "collective_permute"
    assert attr.classify_collective("weird-collective") == \
        "other_collective"


# --------------------------------------------------------------------------
# TraceCapture: a real torch.profiler capture on the CPU
# --------------------------------------------------------------------------


def _trace_files(root):
    return [os.path.join(r, f) for r, _, fs in os.walk(root) for f in fs]


def test_trace_capture_writes_nonempty_dir(tmp_path):
    tel = Telemetry(annotate_spans=False)
    pdir = str(tmp_path / "cap")
    with attr.TraceCapture(pdir, telemetry=tel) as cap:
        (torch.ones(8) * 2).sum()
    assert _trace_files(pdir) == [cap.path]
    assert cap.path.endswith(".trace.json")
    assert os.path.getsize(cap.path) > 0
    assert tel.registry.counter_value("attribution.trace_captures") == 1
    events, _ = attr.load_trace_events(cap.path)
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_trace_capture_stops_on_body_exception(tmp_path):
    """The crash-safety contract: the session stops (and the trace lands
    on disk) even when the body raises, and the exception propagates
    unmasked."""
    tel = Telemetry(annotate_spans=False)
    pdir = str(tmp_path / "cap")
    with pytest.raises(ValueError, match="boom"):
        with attr.TraceCapture(pdir, telemetry=tel):
            torch.ones(4) + 1
            raise ValueError("boom")
    assert _trace_files(pdir), "crash path must still flush the trace"
    assert not attr._SESSION.locked()
    with attr.TraceCapture(str(tmp_path / "cap2"), telemetry=tel):
        pass
    assert tel.registry.counter_value(
        "attribution.trace_stop_failures") == 0
    assert tel.registry.counter_value(
        "attribution.trace_start_failures") == 0


def test_trace_capture_none_dir_is_noop():
    tel = Telemetry(annotate_spans=False)
    with attr.TraceCapture(None, telemetry=tel) as tc:
        assert not tc.active
    assert tel.registry.counter_value("attribution.trace_captures") == 0
    assert tc.path is None


def test_trace_capture_attributes_its_own_cost(tmp_path):
    tel = Telemetry(annotate_spans=False)
    timer = tel.stage_timer()
    with attr.TraceCapture(str(tmp_path / "cap"), telemetry=tel,
                           timer=timer):
        pass
    assert timer.totals().get("trace_capture", 0.0) > 0.0


def test_a_capture_inside_a_capture_fails_to_start_not_the_body(tmp_path):
    """One profiler a process: the inner capture is counted as a start
    failure, the body runs, and the outer capture still exports its
    trace with the inner body's work in it."""
    tel = Telemetry(annotate_spans=False)
    ran = []
    with attr.TraceCapture(str(tmp_path / "outer"), telemetry=tel) as outer:
        with attr.TraceCapture(str(tmp_path / "inner"),
                               telemetry=tel) as inner:
            assert not inner.active
            ran.append((torch.arange(16) * 3).sum())
    assert ran and inner.path is None
    assert tel.registry.counter_value("attribution.trace_captures") == 1
    assert tel.registry.counter_value(
        "attribution.trace_start_failures") == 1
    assert not os.path.exists(tmp_path / "inner")
    assert _trace_files(str(tmp_path / "outer")) == [outer.path]


def test_a_cpu_capture_has_no_device_time(tmp_path):
    """A CPU capture yields ``available: false`` with zeroed totals; the
    host's stage annotations are still read."""
    tel = Telemetry()
    pdir = str(tmp_path / "cap")
    with attr.TraceCapture(pdir, telemetry=tel):
        with tel.stage_timer()("grid"):
            torch.ones(32).cumsum(0)
    block = attr.device_time_block(pdir)
    assert block["available"] is False
    assert block["device_time_s"] == 0.0 and block["by_class_s"] == {}
    s = attr.summarize_trace_dir(pdir)
    assert s["stage_annotations_us"].get("grid", 0.0) > 0.0


# --------------------------------------------------------------------------
# the driver inside a capture
# --------------------------------------------------------------------------


def test_pipeline_trace_nonempty_and_reconciled(tmp_path, rng):
    """A run with ``profile_dir`` leaves a non-empty trace with the
    driver's stages (the producer thread's too) AND a reconciliation
    block whose stage terms cover the wall within tolerance."""
    md = _write_days(tmp_path, rng)
    pdir = str(tmp_path / "trace")
    tel = Telemetry()
    t = compute_exposures(
        md, NAMES, cfg=Config(days_per_batch=2, profile_dir=pdir),
        telemetry=tel)
    assert _trace_files(pdir), "profile_dir produced no trace files"
    block = t.reconciliation
    assert block["ok"], block
    assert "unattributed_s" in block
    assert "trace_capture" in block["stages"]
    assert tel.registry.counter_value("attribution.trace_captures") == 1
    stages = attr.summarize_trace_dir(pdir)["stage_annotations_us"]
    assert {"io", "grid", "wire_encode", "launch", "device"} <= set(stages)


def test_pipeline_trace_stopped_on_abort(tmp_path, rng, monkeypatch):
    """A mid-run abort must still stop the capture and flush its trace."""
    md = _write_days(tmp_path, rng)
    pdir = str(tmp_path / "trace")

    def explode(*a, **kw):
        raise RuntimeError("synthetic device wedge")

    monkeypatch.setattr(pl, "_run_device_pipeline", explode)
    with pytest.raises(RuntimeError, match="synthetic device wedge"):
        compute_exposures(
            md, NAMES, cfg=Config(days_per_batch=2, profile_dir=pdir),
            telemetry=Telemetry(annotate_spans=False))
    assert _trace_files(pdir), "abort path dropped the trace"
    tel2 = Telemetry(annotate_spans=False)
    with attr.TraceCapture(str(tmp_path / "t2"), telemetry=tel2):
        pass
    assert tel2.registry.counter_value(
        "attribution.trace_start_failures") == 0


def test_profiled_run_has_the_bits_of_an_unprofiled_one(tmp_path, rng):
    md = _write_days(tmp_path, rng)
    plain = compute_exposures(md, NAMES, cfg=Config(days_per_batch=2))
    traced = compute_exposures(
        md, NAMES, cfg=Config(days_per_batch=2,
                              profile_dir=str(tmp_path / "trace")))
    assert list(traced.columns) == list(plain.columns)
    for k, v in plain.columns.items():
        if k in NAMES:
            assert traced.columns[k].tobytes() == v.tobytes(), k
        else:
            assert list(traced.columns[k]) == list(v), k
