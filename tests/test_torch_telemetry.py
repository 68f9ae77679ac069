"""The port's telemetry planes, each pinned to the JAX package's on the
same inputs: the Prometheus text, the SLO burn evaluations, the timeline
frames, the flight recorder's dumps, the span tree and its Chrome trace,
the factor-health and mesh planes, and ``Telemetry.write``'s bundle
(valid under the JAX package's ``validate_jsonl`` and ``validate_dir``,
with its artifact set). The HBM sampler reads ``torch.cuda.memory_stats``
(held here against a stand-in for the allocator; on the card by
tests/test_torch_cuda.py) and reports itself unavailable on the CPU."""

import json
import os
import re

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu import telemetry as jtel
from replication_of_minute_frequency_factor_tpu.telemetry import (
    factorplane as jfp)
from replication_of_minute_frequency_factor_tpu.telemetry import (
    meshplane as jmp)
from replication_of_minute_frequency_factor_tpu.telemetry import slo as jslo
from replication_of_minute_frequency_factor_tpu.telemetry.validate import (
    validate_dir, validate_dump)
from replication_of_minute_frequency_factor_tpu_torch import (
    telemetry as ttel)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    factorplane as tfp)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    meshplane as tmp_)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    slo as tslo)

PACKAGES = {"jax": jtel, "port": ttel}


def _feed(tel) -> None:
    """The same metric traffic into either package's Telemetry."""
    for i in range(40):
        tel.counter("serve.requests", kind="factors")
        tel.observe("serve.request_seconds", 0.001 * (i % 7 + 1),
                    kind="factors")
        if i % 9 == 0:
            tel.counter("serve.load_shed", reason="breaker")
    tel.gauge("serve.queue_depth", 3)
    tel.gauge("device.hbm_bytes_in_use", 1.5e9, device="cuda:0",
              source="memory_stats")
    tel.counter("edge.answers", 5, encoding="wire")
    tel.observe("span_seconds", 0.25, span="io")


def test_to_prometheus_text_equals_jax():
    texts = {}
    for label, pkg in PACKAGES.items():
        tel = pkg.Telemetry()
        _feed(tel)
        texts[label] = pkg.to_prometheus(tel.registry)
    assert texts["port"] == texts["jax"]
    assert "serve_requests" in texts["port"]
    reg = {}
    for label, mod in (("jax", jslo), ("port", tslo)):
        tel = PACKAGES[label].Telemetry()
        _feed(tel)
        tel.gauge("slo.burn_rate", 2.5, objective="availability",
                  window="fast")
        reg[label] = mod.slo_prometheus(tel.registry)
    assert reg["port"] == reg["jax"] and "slo_burn_rate" in reg["port"]


def test_registry_records_and_reingest_equal_jax():
    recs = {}
    for label, pkg in PACKAGES.items():
        tel = pkg.Telemetry()
        _feed(tel)
        again = pkg.MetricsRegistry()
        for rec in tel.registry.records():
            again.ingest_record(rec)
        recs[label] = (tel.registry.records(), again.snapshot())
    assert recs["port"] == recs["jax"]


def _slo_run(pkg, mod):
    """A deterministic SLO history: a healthy stretch, then a shed burst,
    evaluated on a fake clock at time_scale 3600."""
    tel = pkg.Telemetry()
    now = [1000.0]
    plane = tel.sloplane.configure(
        mod.serve_objectives(latency_ms=5.0, staleness_s=10.0,
                             streaming=True),
        time_scale=3600.0, clock=lambda: now[0])
    evals = []
    for step in range(30):
        now[0] += 0.05
        tel.counter("serve.requests", 10, kind="factors")
        if step >= 15:
            tel.counter("serve.load_shed", 8, reason="breaker")
        series = {"p99:serve.request_seconds{kind=factors}":
                  0.002 if step < 20 else 0.02,
                  "gauge:stream.staleness_s": float(step)}
        evals.append(plane.evaluate({"series": series}))
    return evals, plane.summary(), tel.registry.snapshot()


def test_slo_burn_evaluations_equal_jax():
    j = _slo_run(jtel, jslo)
    t = _slo_run(ttel, tslo)
    assert t[0] == j[0]
    assert any(e["availability"]["alerting"] for e in t[0])
    assert t[1] == j[1]
    slo_keys = {k for k in j[2]["gauges"] if k.startswith("slo.")}
    assert {k: t[2]["gauges"][k] for k in slo_keys} \
        == {k: j[2]["gauges"][k] for k in slo_keys}
    assert t[2]["counters"] == j[2]["counters"]


def _timeline_run(pkg):
    tel = pkg.Telemetry()
    now = [50.0]
    tl = tel.timeline
    tl.clock = lambda: now[0]
    tl.add_source(lambda: {"stream.staleness_s": now[0] - 50.0})
    frames = []
    for step in range(6):
        now[0] += 0.5
        _feed(tel)
        frames.append(tl.sample())
    query = tl.query(name="serve.requests", limit=3)
    movers = tl.top_movers(window_s=10.0, k=3)
    recs = tl.frame_records()
    for fr in frames + recs + query:
        fr.pop("ts", None)
    return frames, query, movers, recs


def test_timeline_frames_equal_jax():
    j = _timeline_run(jtel)
    t = _timeline_run(ttel)
    assert t == j
    assert len(t[0]) == 6 and len(t[1]) == 3


def _spans(pkg):
    tel = pkg.Telemetry()
    tr = tel.tracer
    with tr("serve.dispatch"):
        with tr("serve.ingest", trace_id="req-1"):
            pass
        with tr("collective", kind="host_dispatch"):
            pass
    tr.add_span("serve.queue_wait", tr._epoch + 0.5, 0.25,
                trace_id="req-2")
    with tel.stage_timer(rolling_impl="cuda")("io"):
        pass
    events = [{k: v for k, v in ev.items()
               if k not in ("ts_us", "dur_us", "tid")}
              for ev in tr.events()]
    chrome = tr.to_chrome_trace()
    shape = [{k: (v if k not in ("ts", "dur", "tid", "pid") else None)
              for k, v in ev.items()} for ev in chrome["traceEvents"]]
    hist = tel.registry.histogram_stats("span_seconds", span="io",
                                        rolling_impl="cuda")
    return events, shape, sorted(chrome), sorted(tr.totals()), \
        hist["count"]


def test_span_tree_and_chrome_trace_equal_jax_in_structure():
    j, t = _spans(jtel), _spans(ttel)
    assert t == j
    depths = {ev["name"]: ev["depth"] for ev in t[0]}
    assert depths["serve.ingest"] == 1 and depths["serve.dispatch"] == 0


def test_flight_dumps_validate_under_jax(tmp_path):
    rec = ttel.FlightRecorder(telemetry=ttel.Telemetry(), ring=4,
                              dump_dir=str(tmp_path))
    for i in range(6):
        rec.record_request({"trace_id": f"t{i}", "op": "factors",
                            "status": "ok", "data": {"total_s": 0.01}})
    rec.note_dispatch({"dispatch_id": 6, "op": "block"})
    path = rec.dump("manual", force=True)
    assert path and os.path.exists(path)
    assert len(rec) == 4
    verdict = validate_dump(path)
    assert verdict["problems"] == [], verdict
    assert verdict["kinds"].get("dump") == 1
    assert ttel.canonical_trace_id("abc-1") == "abc-1"
    assert len(ttel.canonical_trace_id("bad id!")) == 16


def test_telemetry_write_bundle_has_the_jax_artifact_set(tmp_path):
    out = {}
    for label, pkg in PACKAGES.items():
        tel = pkg.Telemetry()
        _feed(tel)
        with tel.span("outer"):
            pass
        tel.event("reconciliation", ok=True)
        tel.request({"trace_id": "r1", "op": "ic", "status": "ok",
                     "data": {"total_s": 0.002}})
        tel.counter("serve.executables", outcome="miss")
        tel.timeline.sample()
        tel.sloplane.configure(
            (pkg.Objective("availability", "availability",
                           target=0.99),), time_scale=3600.0)
        tel.sloplane.evaluate()
        d = tmp_path / label
        paths = tel.write(str(d), manifest_extra={"run_kind": "test"})
        kinds = {}
        with open(paths["metrics"]) as fh:
            for line in fh:
                rec = json.loads(line)
                kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
        manifest = json.load(open(paths["manifest"]))
        # the digest's lines with their numbers out (the spans' times
        # differ between runs)
        digest = [re.sub(r"[-+]?\d[\d.e+-]*", "#", line)
                  for line in tel.summary().splitlines()]
        out[label] = (sorted(paths), sorted(os.listdir(d)), kinds,
                      manifest, digest)
    j, t = out["jax"], out["port"]
    assert t[0] == j[0] and t[1] == j[1]
    assert t[2] == j[2]
    assert set(t[2]) >= {"manifest", "counter", "gauge", "histogram",
                         "span", "event", "request", "frame", "slo"}
    for line, problems in jtel.validate_jsonl(
            str(tmp_path / "port" / "metrics.jsonl")):
        assert problems == [], (line, problems)
    assert validate_dir(str(tmp_path / "port"))["ok"]
    # the manifest: JAX's keys less its analysis and xla blocks, with the
    # executable cache's counts in their place
    jkeys, tkeys = set(j[3]), set(t[3])
    assert tkeys == (jkeys - {"analysis", "xla"}) | {"executables"}
    assert t[3]["executables"] == {"hits": 0, "misses": 1,
                                   "resident": None}
    assert "torch" in t[3]["versions"] and "jax" not in t[3]["versions"]
    assert t[3]["schema"] == j[3]["schema"] == jtel.SCHEMA_VERSION
    assert t[4] == j[4]


def _factor_plane(mod, tel):
    plane = mod.FactorPlane(telemetry=tel, burst=2)
    rng = np.random.default_rng(5)
    names = ("a", "b", "c")
    outs = []
    for step in range(5):
        x = rng.standard_normal((3, 4, 16)).astype(np.float32)
        if step >= 2:
            x[1] += 100.0           # factor b drifts
            x[2, :, :12] = np.nan   # factor c loses coverage
        outs.append(plane.observe_block(names,
                                        mod.factor_stats_host(x),
                                        boundary="test"))
    plane.observe_widen(names, [1, 0, 2], 4)
    plane.observe_stream(names, ready_frac=[1.0, 0.5, 0.25], minute=7)
    plane.note_ic("a", 0.05, horizon=1)
    plane.note_ic("a", 0.07, horizon=1)
    return outs, plane.summary(), tel.registry.snapshot()


def test_factor_plane_equals_jax():
    j = _factor_plane(jfp, jtel.Telemetry())
    t = _factor_plane(tfp, ttel.Telemetry())
    assert t == j
    assert t[1]["drift"]["bursts"] >= 1


def test_factor_plane_takes_a_stats_tensor():
    tel = ttel.Telemetry()
    x = torch.randn(2, 3, 8)
    out = tel.factorplane.observe_block(("a", "b"),
                                        tfp.factor_stats_block(x))
    assert out["factors"] == 2
    assert tel.factorplane.summary()["available"]


def test_mesh_plane_one_device_surface_equals_jax():
    res = {}
    for label, mod, pkg in (("jax", jmp, jtel), ("port", tmp_, ttel)):
        tel = pkg.Telemetry()
        plane = mod.MeshPlane(telemetry=tel, burst=2)
        plane.record_occupancy(0.4, boundary="serve.dispatch")
        plane.record_pad_waste(5000, 5120)
        samples = [plane.record_shard_times({"cuda:0": 0.01,
                                             "cuda:1": 0.05,
                                             "cuda:2": 0.011},
                                            boundary="x")
                   for _ in range(2)]
        for s in samples:
            s.pop("burst_dump")
        res[label] = (samples, plane.summary(), tel.registry.snapshot())
    assert res["port"] == res["jax"]
    # the mesh methods: per-axis samples and collective counts as JAX's
    res = {}
    for label, mod, pkg in (("jax", jmp, jtel), ("port", tmp_, ttel)):
        tel = pkg.Telemetry()
        plane = mod.MeshPlane(telemetry=tel)
        axes = [plane.record_axis_times("days", {"day0": 1.0, "day1": 3.0}),
                plane.record_axis_times("tickers", {"ticker0": 0.5})]
        plane.note_collective("psum")
        plane.note_collective("carry_handoff")
        res[label] = (axes, plane.summary(), tel.registry.snapshot())
    assert res["port"] == res["jax"]
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh)
    plane = tmp_.MeshPlane(telemetry=ttel.Telemetry())
    out = plane.measure_ready(torch.zeros(3))
    assert out["n_shards"] == 1
    mesh = make_mesh(None, "cpu")
    out = plane.measure_ready_mesh(torch.zeros(3), mesh, boundary="m")
    assert out["n_shards"] == 1 and set(out["axes"]) == {"days", "tickers"}
    plane.watch_async_mesh(torch.zeros(3), mesh, boundary="w")
    plane.drain()
    assert plane.summary()["boundaries"] == {"manual": 1, "m": 1, "w": 1}


def test_hbm_sampler_is_unavailable_on_the_cpu():
    tel = ttel.Telemetry()
    s = tel.hbm.configure(device="cpu")
    out = s.sample("test", force=True)
    assert out["available"] is False and out["source"] == "unavailable"
    assert out["bytes_in_use"] == 0 and out["peak_bytes"] == 0
    gauges = tel.registry.snapshot()["gauges"]
    assert gauges["device.hbm_stats_available{device=cpu}"] == 0.0


def test_hbm_sampler_reads_the_cuda_allocator(monkeypatch):
    """The CUDA branch against a stand-in allocator: the current and
    peak allocated bytes per card, available, and the peak sticky."""
    stats = {0: {"allocated_bytes.all.current": 1000,
                 "allocated_bytes.all.peak": 5000},
             1: {"allocated_bytes.all.current": 7,
                 "allocated_bytes.all.peak": 9}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    tel = ttel.Telemetry()
    s = tel.hbm
    out = s.sample("test", force=True)
    assert out["available"] is True and out["source"] == "memory_stats"
    assert out["devices"]["cuda:0"] == {"bytes_in_use": 1000,
                                        "peak_bytes": 5000,
                                        "available": True,
                                        "source": "memory_stats"}
    assert out["bytes_in_use"] == 1007 and out["peak_bytes"] == 5000
    stats[0] = {"allocated_bytes.all.current": 10,
                "allocated_bytes.all.peak": 10}
    assert s.sample("test", force=True)["peak_bytes"] == 5000
    reg = tel.registry
    assert reg.gauge_value("device.hbm_bytes_in_use", device="cuda:0",
                           source="memory_stats") == 10.0
    assert reg.counter_value("device.hbm_samples", boundary="test") == 2


def test_lock_assertions_arm_on_the_port_planes(monkeypatch):
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        lockcheck)
    monkeypatch.setenv("MFF_LOCK_ASSERT", "1")
    reg = ttel.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(lockcheck.LockAssertionError, match="_counters"):
        reg._counters[("y", ())] = 1.0
    tel = ttel.Telemetry()
    tel.counter("ok")  # the locked path stays legal
    assert tel.registry.counter_value("ok") == 1.0
