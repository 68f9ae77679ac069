"""The port's factor server, held to tests/test_serve.py.

Two parts. First the port's server and the JAX package's server answer
the same queries over the same seeded ``SyntheticSource`` (8 days x 32
tickers; ``mmt_ols_qrs`` puts the rolling path's plain version on the
block graph): exposures within tests/test_parity.py's comparator (the
one tests/test_torch_factors.py holds the 58 factors to) with NaN
positions identical, IC within tests/test_torch_eval.py's IC tolerance,
decile counts bitwise on a factor whose exposures are bitwise between the
packages, wire payloads that both packages' decoders read to the same
values, and the source itself bitwise. Then every behaviour of the JAX
package's serve tests, run against the port on the CPU
(``device='cpu'``): warm repeats, the LRU, coalescing, shedding, the
breaker and its half-open probe, HTTP codes and Retry-After, health,
streaming ingest and intraday, the SLO and timeline surfaces, and
``serve --demo`` through the port's CLI. Where the JAX tests read
``xla.compiles``, these read the executable cache's
``serve.executables{outcome=miss}``: the callables a request built.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from replication_of_minute_frequency_factor_tpu_torch.serve import (
    DeviceExposureCache, FactorServer, LoadShedError, Query, ServeConfig,
    SyntheticSource, serve_http)
from replication_of_minute_frequency_factor_tpu_torch.serve.engine import (
    ServeEngine)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry)

NAMES = ("vol_return1min", "mmt_am", "liq_openvol")


def _built(reg) -> float:
    """Callables built so far: the port's form of ``xla.compiles``."""
    return reg.counter_value("serve.executables", outcome="miss")


def _server(n_days=8, n_tickers=32, names=NAMES, start=True,
            stream=False, stream_batches=(1,), **scfg):
    tel = Telemetry()
    src = SyntheticSource(n_days=n_days, n_tickers=n_tickers, seed=3)
    srv = FactorServer(src, names=names, telemetry=tel,
                       serve_cfg=ServeConfig(**scfg), start=start,
                       stream=stream, stream_batches=stream_batches,
                       device="cpu")
    return srv, tel


def _day_minutes(src, lo, hi):
    """Host ``(bars [B, T, 5], present [B, T])`` for minutes
    ``[lo, hi)`` of the source's day 0."""
    bars, mask = src.slab(0, 1)
    return (np.ascontiguousarray(np.swapaxes(bars[0][:, lo:hi], 0, 1)),
            np.ascontiguousarray(mask[0][:, lo:hi].T))


# --------------------------------------------------------------------------
# warm executables + exposure cache
# --------------------------------------------------------------------------


def test_second_identical_request_compiles_nothing():
    """Request 1 builds the block callable (a miss of the executable
    cache); request 2 over the same range must be answered warm — build
    counter delta ZERO and an exposure-cache hit."""
    srv, tel = _server()
    try:
        c = srv.client()
        r1 = c.factors(0, 4)
        reg = tel.registry
        after_first = _built(reg)
        assert after_first >= 1
        r2 = c.factors(0, 4)
        assert _built(reg) == after_first
        assert reg.counter_value("serve.cache", outcome="hit") == 1
        assert reg.counter_value("serve.cache", outcome="miss") == 1
        assert reg.counter_total("serve.dispatches") == 1
        for n in NAMES:
            np.testing.assert_array_equal(r1["exposures"][n],
                                          r2["exposures"][n])
    finally:
        srv.close()


def test_served_exposures_match_direct_compute():
    """The served block is the graph the batch entry point runs, through
    the wire codec: values must match a direct ``compute_batch`` over
    the raw slab within the JAX test's decode wobble (rtol 2e-4), and
    equal, bitwise, ``compute_batch`` on the block's DECODED bars."""
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_batch, wire)
    srv, _ = _server()
    try:
        r = srv.client().factors(1, 5)
        bars, mask = srv.source.slab(1, 5)
        direct = compute_batch(bars, mask, names=NAMES,
                               device="cpu").numpy()
        w = wire.encode(bars, mask)
        dbars, dmask = wire.decode(*[torch.from_numpy(np.asarray(a))
                                     for a in w.arrays])
        own = compute_batch(dbars, dmask, names=NAMES,
                            device="cpu").numpy()
        for i, n in enumerate(NAMES):
            got = np.asarray(r["exposures"][n], np.float32)
            np.testing.assert_allclose(got, direct[i], rtol=2e-4,
                                       atol=1e-7)
            np.testing.assert_array_equal(got, own[i])
    finally:
        srv.close()


def test_ic_and_decile_answers_are_consistent():
    """IC lies in [-1, 1] where defined, the last `horizon` days are
    NaN (no forward close), and decile counts sum to the per-day valid
    cross-section."""
    srv, _ = _server()
    try:
        c = srv.client()
        ic = c.ic("vol_return1min", 0, 6, horizon=2)
        arr = np.asarray(ic["ic"], np.float64)
        assert arr.shape == (6,)
        assert np.all(np.isnan(arr[-2:]))
        finite = arr[np.isfinite(arr)]
        assert finite.size and np.all(np.abs(finite) <= 1.0 + 1e-6)
        dec = c.decile("mmt_am", 0, 6, horizon=1, group_num=4)
        counts = np.asarray(dec["counts"])
        assert counts.shape == (6, 4)
        assert counts.sum() > 0
        mean_ret = np.asarray(dec["mean_fwd_ret"], np.float64)
        assert np.all(np.isnan(mean_ret[-1]))  # no forward day in block
    finally:
        srv.close()


def test_cache_eviction_under_small_byte_budget():
    """A budget sized for ~1 block forces LRU eviction on the second
    range and a re-miss on the first; counters and the bytes gauge must
    say so."""
    srv, tel = _server(cache_bytes=0)  # probe: disabled cache still works
    try:
        srv.client().factors(0, 2)
        assert tel.registry.counter_total("serve.cache_oversize") == 1
    finally:
        srv.close()

    # size the budget from a real block: fits one, not two
    src = SyntheticSource(n_days=8, n_tickers=32, seed=3)
    probe_tel = Telemetry()
    probe = FactorServer(src, names=NAMES, telemetry=probe_tel,
                         device="cpu")
    try:
        probe.client().factors(0, 2)
        block_bytes = probe_tel.registry.gauge_value("serve.cache_bytes")
    finally:
        probe.close()
    assert block_bytes and block_bytes > 0

    srv, tel = _server(cache_bytes=int(block_bytes * 1.5))
    try:
        c = srv.client()
        c.factors(0, 2)                 # miss, cached
        c.factors(2, 4)                 # miss, evicts [0, 2)
        c.factors(0, 2)                 # miss again, evicts [2, 4)
        reg = tel.registry
        assert reg.counter_value("serve.cache", outcome="miss") == 3
        assert reg.counter_total("serve.cache_evictions") == 2
        assert reg.gauge_value("serve.cache_bytes") <= block_bytes * 1.5
        assert reg.gauge_value("serve.cache_entries") == 1
    finally:
        srv.close()


def test_expcache_lru_order_and_delete():
    """Unit-level LRU semantics: a get() refreshes recency, eviction
    drops the evicted entry's tensors (torch's form of JAX's
    ``.delete()``)."""
    tel = Telemetry()
    cache = DeviceExposureCache(byte_budget=3 * 4 * 10, telemetry=tel)

    def entry():
        return {"x": torch.zeros(10, dtype=torch.float32)}  # 40 bytes

    a, b, c = entry(), entry(), entry()
    cache.put("a", a)
    cache.put("b", b)
    cache.put("c", c)
    assert cache.get("a") is not None   # refresh a: LRU is now b
    cache.put("d", entry())             # evicts b
    assert cache.get("b") is None
    assert cache.get("a") is not None
    assert b == {}
    assert a["x"].shape == (10,)
    assert tel.registry.counter_total("serve.cache_evictions") == 1


# --------------------------------------------------------------------------
# coalescing + queue
# --------------------------------------------------------------------------


def test_concurrent_identical_range_queries_coalesce():
    """K queued queries over one fresh range drain as ONE micro-batch
    and are answered by ONE device dispatch — counter-asserted."""
    srv, tel = _server(start=False)
    try:
        futs = [srv.submit(Query("factors", 2, 6, names=("mmt_am",)))
                for _ in range(6)]
        futs.append(srv.submit(Query("ic", 2, 6, factor="mmt_am")))
        futs.append(srv.submit(Query("decile", 2, 6,
                                     factor="vol_return1min")))
        srv.start()
        results = [f.result(120) for f in futs]
        reg = tel.registry
        assert reg.counter_total("serve.dispatches") == 1
        assert reg.counter_value("serve.coalesced_dispatches") == 1
        assert reg.counter_value("serve.coalesced_requests") == 8
        assert reg.histogram_stats("serve.batch_size")["max"] == 8
        for r in results[:6]:
            np.testing.assert_array_equal(r["exposures"]["mmt_am"],
                                          results[0]["exposures"]["mmt_am"])
    finally:
        srv.close()


def test_mixed_ranges_in_one_batch_dispatch_per_range():
    srv, tel = _server(start=False)
    try:
        f1 = [srv.submit(Query("factors", 0, 2)) for _ in range(3)]
        f2 = [srv.submit(Query("factors", 2, 4)) for _ in range(2)]
        srv.start()
        for f in f1 + f2:
            f.result(120)
        reg = tel.registry
        assert reg.counter_total("serve.dispatches") == 2
        assert reg.counter_value("serve.coalesced_requests") == 5
    finally:
        srv.close()


def test_full_queue_sheds():
    srv, tel = _server(start=False, queue_limit=2)
    try:
        srv.submit(Query("factors", 0, 2))
        srv.submit(Query("factors", 0, 2))
        with pytest.raises(LoadShedError, match="queue full"):
            srv.submit(Query("factors", 0, 2))
        assert tel.registry.counter_value("serve.load_shed",
                                          reason="queue_full") == 1
        srv.start()  # drain the two queued requests on close
    finally:
        srv.close()


def test_validation_errors_raise_on_the_callers_thread():
    srv, _ = _server()
    try:
        with pytest.raises(ValueError, match="outside"):
            srv.submit(Query("factors", 0, 99))
        with pytest.raises(ValueError, match="unknown factor"):
            srv.submit(Query("ic", 0, 4, factor="nope"))
        with pytest.raises(ValueError, match="horizon"):
            srv.submit(Query("ic", 0, 2, factor="mmt_am", horizon=5))
        with pytest.raises(ValueError, match="kind"):
            srv.submit(Query("frobnicate", 0, 2))
    finally:
        srv.close()


# --------------------------------------------------------------------------
# breaker / load shedding
# --------------------------------------------------------------------------


def _boom(bars, mask):
    raise RuntimeError("injected device failure")


def test_breaker_opens_and_sheds_after_consecutive_failures():
    srv, tel = _server(breaker_threshold=2, breaker_cooldown_s=30.0)
    try:
        srv.engine.build_block = _boom
        for _ in range(2):
            with pytest.raises(RuntimeError, match="injected"):
                srv.submit(Query("factors", 0, 2)).result(60)
        with pytest.raises(LoadShedError, match="breaker open"):
            srv.submit(Query("factors", 0, 2))
        reg = tel.registry
        assert reg.counter_total("serve.breaker_trips") == 1
        assert reg.counter_value("serve.load_shed", reason="breaker") == 1
        assert reg.gauge_value("serve.breaker_consecutive_failures") == 2
    finally:
        srv.close()


def test_breaker_half_open_probe_recovers():
    srv, tel = _server(breaker_threshold=1, breaker_cooldown_s=0.15)
    try:
        srv.engine.build_block = _boom
        with pytest.raises(RuntimeError, match="injected"):
            srv.submit(Query("factors", 0, 2)).result(60)
        with pytest.raises(LoadShedError):
            srv.submit(Query("factors", 0, 2))
        # heal the engine, wait out the cooldown: the next request is
        # the half-open probe and closes the breaker on success
        srv.engine = ServeEngine(srv.names, telemetry=srv.telemetry,
                                 executables=srv.executables,
                                 device="cpu")
        time.sleep(0.2)
        r = srv.submit(Query("factors", 0, 2)).result(60)
        assert "exposures" in r
        assert tel.registry.gauge_value(
            "serve.breaker_consecutive_failures") == 0
        r2 = srv.submit(Query("factors", 2, 4)).result(60)
        assert "exposures" in r2
    finally:
        srv.close()


# --------------------------------------------------------------------------
# HTTP binding
# --------------------------------------------------------------------------


def _post(port, doc, path="/v1/query"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_http_round_trip_matches_in_process_client():
    srv, tel = _server()
    httpd = None
    try:
        httpd, _t = serve_http(srv)
        port = httpd.server_address[1]
        status, via_http = _post(port, {"kind": "ic", "start": 0,
                                        "end": 4,
                                        "factor": "vol_return1min"})
        assert status == 200
        direct = srv.client().ic("vol_return1min", 0, 4)
        assert via_http["mean_ic"] == direct["mean_ic"]
        np.testing.assert_array_equal(
            np.asarray(via_http["ic"], np.float64),
            np.asarray(direct["ic"], np.float64))
        # factors round-trip
        status, r = _post(port, {"kind": "factors", "start": 0, "end": 2,
                                 "names": ["mmt_am"]})
        assert status == 200 and list(r["exposures"]) == ["mmt_am"]
        assert len(r["exposures"]["mmt_am"]) == 2
        # health + metrics surfaces
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            h = json.loads(resp.read())
        assert h["ok"] and h["breaker_open"] is False
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/metrics",
                timeout=30) as resp:
            snap = json.loads(resp.read())
        assert "serve.dispatches" in snap["counters"]
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.close()


def test_http_error_codes():
    srv, _ = _server(breaker_threshold=1, breaker_cooldown_s=30.0)
    httpd = None
    try:
        httpd, _t = serve_http(srv)
        port = httpd.server_address[1]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"kind": "factors", "start": 0, "end": 99})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"kind": "factors"}, path="/v1/nope")
        assert e.value.code == 404
        # a failing engine: 500 on the dispatch, then 503 once shedding
        srv.engine.build_block = _boom
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"kind": "factors", "start": 0, "end": 2})
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"kind": "factors", "start": 0, "end": 2})
        assert e.value.code == 503
        assert json.loads(e.value.read())["shed"] is True
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.close()


def test_shed_503_carries_retry_after_header():
    """Both shed shapes answer 503 WITH a
    ``Retry-After`` backoff hint derived from the breaker cooldown —
    the remaining cooldown on a breaker shed, the full cooldown on a
    full-queue shed."""
    # breaker-open shed: remaining cooldown (<= 30 s, >= 1 s rounded)
    srv, _ = _server(breaker_threshold=1, breaker_cooldown_s=30.0)
    httpd = None
    try:
        httpd, _t = serve_http(srv)
        port = httpd.server_address[1]
        srv.engine.build_block = _boom
        with pytest.raises(urllib.error.HTTPError):
            _post(port, {"kind": "factors", "start": 0, "end": 2})
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"kind": "factors", "start": 0, "end": 2})
        assert e.value.code == 503
        retry = int(e.value.headers["Retry-After"])
        assert 1 <= retry <= 30
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.close()
    # full-queue shed: the cooldown as the backoff hint
    srv2, _ = _server(start=False, queue_limit=1,
                      breaker_cooldown_s=7.0)
    httpd2 = None
    try:
        httpd2, _t = serve_http(srv2)
        port = httpd2.server_address[1]
        srv2.submit(Query("factors", 0, 2))  # fills the queue
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"kind": "factors", "start": 0, "end": 2})
        assert e.value.code == 503
        assert int(e.value.headers["Retry-After"]) == 7
        srv2.start()  # drain on close
    finally:
        if httpd2 is not None:
            httpd2.shutdown()
        srv2.close()


def test_load_shed_error_carries_retry_after_attr():
    """The in-process face of the same hint: LoadShedError.retry_after_s
    is set on both shed shapes (the fleet router reads it to pick the
    pod Retry-After)."""
    srv, _ = _server(start=False, queue_limit=1, breaker_cooldown_s=5.0)
    try:
        srv.submit(Query("factors", 0, 2))
        with pytest.raises(LoadShedError) as e:
            srv.submit(Query("factors", 0, 2))
        assert e.value.retry_after_s == 5.0
        srv.start()
    finally:
        srv.close()


def test_health_carries_replica_identity_block():
    """Healthz (served from FactorServer.health so
    the standalone server and the fleet rollup share one shape) gains
    the ``replica`` identity block — label, device set, breaker
    state."""
    srv, _ = _server(breaker_threshold=1, breaker_cooldown_s=30.0)
    try:
        h = srv.health()
        rep = h["replica"]
        assert rep["label"] == "standalone"  # no identity passed
        assert rep["breaker"] == "closed"
        assert rep["devices"] == ["cpu"]
        # breaker state tracks the ladder
        srv.engine.build_block = _boom
        with pytest.raises(RuntimeError, match="injected"):
            srv.submit(Query("factors", 0, 2)).result(60)
        assert srv.health()["replica"]["breaker"] == "open"
        # the HTTP payload is the same dict
        httpd, _t = serve_http(srv)
        try:
            port = httpd.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz",
                    timeout=30) as resp:
                via_http = json.loads(resp.read())
            assert via_http["replica"]["label"] == "standalone"
            assert via_http["replica"]["breaker"] == "open"
        finally:
            httpd.shutdown()
    finally:
        srv.close()


# --------------------------------------------------------------------------
# smoke + load path (the r8_serve_v1 record)
# --------------------------------------------------------------------------


def test_a_device_list_server_runs_and_spreads_its_placements():
    """A device list builds a replica's server: it runs on the first
    device and ``health()`` names them all. The placements spread one
    server over the list's devices where they apply (several devices),
    and stay on the first device otherwise, silently, as in the JAX
    package (tests/test_torch_placements.py holds what they compute; the
    CPU refusal is tests/test_torch_purity.py's). Discovery is ported:
    ``research=True`` builds a research server (its behaviour is
    tests/test_torch_research.py's)."""
    src = SyntheticSource(n_days=4, n_tickers=8, seed=3)
    with FactorServer(src, names=NAMES, research=True, device="cpu",
                      serve_cfg=ServeConfig(hbm_sample_period_s=0)) as srv:
        assert srv.factor_list()["research"] is True
        assert srv.health()["research"] is True
    with FactorServer(src, names=NAMES, devices=["cpu", "cpu"],
                      replica_label="r0") as srv:
        assert srv.device == torch.device("cpu")
        assert srv.devices == (torch.device("cpu"),) * 2
        rep = srv.health()["replica"]
        assert rep["label"] == "r0" and rep["devices"] == ["cpu", "cpu"]
        a = srv.submit(Query("factors", 0, 2)).result(60)
    with FactorServer(src, names=NAMES, device="cpu") as alone:
        b = alone.submit(Query("factors", 0, 2)).result(60)
    for n in NAMES:
        assert np.asarray(a["exposures"][n]).tobytes() == \
            np.asarray(b["exposures"][n]).tobytes()
    with pytest.raises(ValueError, match="different devices"):
        FactorServer(src, names=NAMES, devices=["cpu"], device="cuda:0")
    for kw, flag, gauge in (
            ({"stream": True}, "stream_sharded", "stream.carry_sharded"),
            ({"research": True}, "discover_sharded", "discover.n_shards")):
        tel = Telemetry()
        with FactorServer(src, names=NAMES, devices=["cpu", "cpu"],
                          start=False, telemetry=tel,
                          serve_cfg=ServeConfig(**{flag: True,
                                                   "hbm_sample_period_s": 0}),
                          **kw):
            assert tel.registry.gauge_value(gauge) == 2
        # one device: the knob does not apply, as in the JAX package
        with FactorServer(src, names=NAMES, devices=["cpu"], start=False,
                          serve_cfg=ServeConfig(**{flag: True,
                                                   "hbm_sample_period_s": 0}),
                          **kw):
            pass


def test_concurrent_clients_under_load_all_answered(monkeypatch):
    """A mini load test through the live queue: N threads, every
    request answered, nothing shed, per-request latency histogram
    populated. Runs with the runtime lock-assert twin armed:
    the breaker state and registry mutate from caller and
    worker threads under load, so a lock-discipline regression raises
    a named LockAssertionError instead of flaking."""
    monkeypatch.setenv("MFF_LOCK_ASSERT", "1")
    srv, tel = _server(n_days=8, n_tickers=24)
    try:
        c = srv.client()
        errors = []

        def client_loop(tid):
            try:
                for j in range(6):
                    kind = (tid + j) % 3
                    if kind == 0:
                        c.factors(0, 4, names=("mmt_am",))
                    elif kind == 1:
                        c.ic("vol_return1min", 0, 4)
                    else:
                        c.decile("liq_openvol", 0, 4)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client_loop, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        reg = tel.registry
        assert reg.counter_total("serve.load_shed") == 0
        assert reg.counter_total("serve.failures") == 0
        stats = reg.histogram_stats("serve.request_seconds", kind="ic")
        assert stats and stats["count"] >= 8
        assert reg.counter_value("serve.cache", outcome="hit") > 0
    finally:
        srv.close()


def test_cli_serve_demo(capsys):
    """``serve --demo 6`` through the port's CLI prints the JAX CLI's
    summary keys."""
    from replication_of_minute_frequency_factor_tpu_torch.__main__ import (
        main)
    rc = main(["serve", "--demo", "6", "--synthetic-days", "6",
               "--synthetic-tickers", "16",
               "--factors", "vol_return1min,mmt_am", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"demo_requests", "factors", "days", "tickers",
                        "dispatches", "cache_hits", "compiles",
                        "ic_p50_s"}
    assert out["demo_requests"] == 6
    assert out["dispatches"] >= 1 and out["cache_hits"] >= 1


# --------------------------------------------------------------------------
# streaming integration: ingest + intraday through the queue
# --------------------------------------------------------------------------


def test_stream_ingest_then_intraday_roundtrip():
    """Minute bars ingested through the queue advance the carry; an
    intraday query returns host exposures + the readiness plane at the
    carry's minute, and the SECOND snapshot compiles nothing (the
    stream engine shares the server's executable cache)."""
    srv, tel = _server(stream=True, stream_batches=(8,))
    try:
        c = srv.client()
        bars, present = _day_minutes(srv.source, 0, 8)
        r = c.ingest(bars, present)
        assert r["minute"] == 8
        assert r["bars"] == int(present.sum())
        snap = c.intraday()
        assert snap["minute"] == 8
        assert set(snap["exposures"]) == set(NAMES)
        assert set(snap["ready"]) == set(NAMES)
        assert len(snap["exposures"]["mmt_am"]) == srv.source.n_tickers
        reg = tel.registry
        before = _built(reg)
        sub = c.intraday(names=("mmt_am",))
        assert list(sub["exposures"]) == ["mmt_am"]
        assert _built(reg) == before
        assert reg.counter_total("stream.snapshots") == 2
    finally:
        srv.close()


def test_stream_ingest_applies_before_intraday_in_one_microbatch():
    """Latest-view semantics: with the worker paused, an intraday
    query enqueued BEFORE an ingest still answers from the advanced
    carry once the batch drains — ingests apply first."""
    srv, _ = _server(stream=True, stream_batches=(4,), start=False)
    try:
        bars, present = _day_minutes(srv.source, 0, 4)
        f_q = srv.submit(Query("intraday"))
        f_i = srv.ingest(bars, present)
        srv.start()
        assert f_i.result(60)["minute"] == 4
        assert f_q.result(60)["minute"] == 4
    finally:
        srv.close()


def test_concurrent_intraday_queries_coalesce_to_one_snapshot():
    """K intraday queries in one micro-batch → ONE snapshot dispatch
    (counter-asserted, the same coalescing contract as block
    queries)."""
    srv, tel = _server(stream=True, start=False)
    try:
        futures = [srv.submit(Query("intraday")) for _ in range(6)]
        srv.start()
        answers = [f.result(60) for f in futures]
        assert all(a["minute"] == 0 for a in answers)
        reg = tel.registry
        assert reg.counter_total("stream.snapshots") == 1
        assert reg.counter_total("serve.coalesced_dispatches") == 1
        assert reg.counter_value("serve.coalesced_requests") == 6
    finally:
        srv.close()


def test_stream_validation_errors():
    """intraday/ingest against a non-streaming server and malformed
    ingest shapes fail fast on the caller's thread."""
    srv, _ = _server()
    try:
        with pytest.raises(ValueError, match="stream=True"):
            srv.submit(Query("intraday"))
        with pytest.raises(ValueError, match="stream=True"):
            srv.ingest(np.zeros((1, 32, 5), np.float32),
                       np.zeros((1, 32), bool))
    finally:
        srv.close()
    srv2, _ = _server(stream=True)
    try:
        with pytest.raises(ValueError, match="bars \\[B, T, 5\\]"):
            srv2.ingest(np.zeros((1, 32, 4), np.float32),
                        np.zeros((1, 32), bool))
        with pytest.raises(ValueError, match="stream engine"):
            srv2.ingest(np.zeros((1, 16, 5), np.float32),
                        np.zeros((1, 16), bool))
        with pytest.raises(ValueError, match="unknown factor"):
            srv2.submit(Query("intraday", names=("nope",)))
    finally:
        srv2.close()


def test_http_ingest_and_intraday_roundtrip():
    """POST /v1/ingest advances the carry; kind=intraday via
    /v1/query reads it back; /healthz reports the minute cursor."""
    srv, _ = _server(stream=True, stream_batches=(2,))
    httpd = None
    try:
        httpd, _t = serve_http(srv)
        port = httpd.server_address[1]
        bars, present = _day_minutes(srv.source, 0, 2)
        status, r = _post(port, {"bars": bars.tolist(),
                                 "present": present.tolist()},
                          path="/v1/ingest")
        assert status == 200 and r["minute"] == 2
        status, snap = _post(port, {"kind": "intraday",
                                    "names": ["mmt_am"]})
        assert status == 200 and snap["minute"] == 2
        assert len(snap["ready"]["mmt_am"]) == srv.source.n_tickers
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            h = json.loads(resp.read())
        assert h["stream_minute"] == 2
        # malformed ingest → 400, not a worker-thread crash
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"bars": [[1, 2]]}, path="/v1/ingest")
        assert e.value.code == 400
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.close()


def test_stream_ingest_failure_bumps_breaker_and_sheds():
    """A failing carry update fails its own future, opens the breaker
    after the threshold, and subsequent ingests shed — backpressure
    reaches the feed as an error."""
    srv, tel = _server(stream=True, breaker_threshold=1,
                       breaker_cooldown_s=30.0)
    try:
        srv.stream_engine.ingest_minutes = _boom
        bars, present = _day_minutes(srv.source, 0, 1)
        with pytest.raises(RuntimeError, match="injected"):
            srv.ingest(bars, present).result(60)
        with pytest.raises(LoadShedError):
            srv.ingest(bars, present)
        assert tel.registry.counter_value("serve.failures",
                                          stage="ingest") == 1
    finally:
        srv.close()


# --------------------------------------------------------------------------
# SLO plane surfaces
# --------------------------------------------------------------------------


def test_http_slo_and_timeline_surfaces():
    """``GET /v1/slo`` serves the burn-rate summary as JSON and the
    ``slo_*``-only Prometheus view; ``GET /v1/timeline`` serves the
    frame ring with name/since/limit filters and 400s a malformed
    query."""
    # cold CPU dispatches overrun the default 250 ms latency budget —
    # lift it so the surface test reads a quiet plane
    srv, tel = _server(stream=True, stream_batches=(2,),
                       slo_latency_ms=10_000.0)
    httpd = None
    try:
        srv.client().factors(0, 2)
        srv.timeline.sample()  # bank a frame (and an SLO evaluation)
        httpd, _t = serve_http(srv)
        port = httpd.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/slo", timeout=30) as resp:
            doc = json.loads(resp.read())
        s = doc["slo"]
        assert s["available"] and s["frames"] >= 1
        # a streaming server declares all three serve objectives
        assert {"availability", "latency",
                "freshness"} <= set(s["objectives"])
        assert s["alerts"] == 0 and doc["evaluation"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/slo?format=prometheus",
                timeout=30) as resp:
            text = resp.read().decode()
        assert "slo_burn_rate" in text
        assert "serve_requests" not in text  # the slo-only view
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}"
                f"/v1/timeline?name=serve.requests&limit=5",
                timeout=30) as resp:
            t = json.loads(resp.read())
        assert t["count"] >= 1 and len(t["frames"]) == t["count"]
        assert all("serve.requests" in k
                   for f in t["frames"] for k in f["series"])
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/timeline?since=yesterday",
                timeout=30)
        assert e.value.code == 400
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.close()


def test_healthz_reports_flight_and_staleness():
    """The healthz flight block counts suppressed
    dumps next to written ones, and a streaming server reports
    wall-clock ``stream_staleness_s`` (None before the first ingest,
    a number after)."""
    srv, _ = _server(stream=True)
    try:
        h = srv.health()
        assert h["flight"] == {"requests": 0, "dumps": 0,
                               "suppressed": 0}
        assert h["stream_staleness_s"] is None
        srv.flight.dump("breaker_trip")
        srv.flight.dump("breaker_trip")  # inside the 1 s rate limit
        bars, present = _day_minutes(srv.source, 0, 2)
        srv.ingest(bars, present).result(120)
        h = srv.health()
        assert h["flight"]["suppressed"] == 1
        assert isinstance(h["stream_staleness_s"], float)
        assert h["stream_staleness_s"] >= 0.0
    finally:
        srv.close()


def test_healthz_reports_resolved_stream_finalize_impl():
    """A streaming server reports the RESOLVED
    snapshot finalize impl in healthz — 'exact' by default, 'fast'
    when requested via ServeConfig AND a foldable kernel is served
    (the degrade-to-exact case is what an operator needs to see)."""
    srv, _ = _server(stream=True)
    try:
        assert srv.health()["stream_finalize_impl"] == "exact"
    finally:
        srv.close()
    srv, _ = _server(stream=True, stream_finalize_impl="fast")
    try:
        assert srv.stream_engine.finalize_impl_resolved == "fast"
        assert srv.health()["stream_finalize_impl"] == "fast"
    finally:
        srv.close()
    # a batch-served (non-streaming) server reports nothing here
    srv, _ = _server()
    try:
        assert "stream_finalize_impl" not in srv.health()
    finally:
        srv.close()


# --------------------------------------------------------------------------
# the port's server against the JAX package's, on the same source
# --------------------------------------------------------------------------

PARITY_NAMES = ("vol_return1min", "mmt_am", "liq_openvol", "mmt_ols_qrs")
PARITY_DAYS, PARITY_TICKERS, PARITY_SEED = 8, 32, 3
#: tests/test_torch_eval.py's IC tolerance (test_torch_masked.py's corr)
IC_RTOL, IC_ATOL = 2e-5, 4 * float(np.finfo(np.float32).eps)


def _ask(client, kind):
    """The parity queries, in one order for both packages."""
    out = {"factors": client.factors(0, PARITY_DAYS)}
    for n in PARITY_NAMES:
        out[f"ic/{n}"] = client.ic(n, 0, PARITY_DAYS, horizon=1)
        out[f"decile/{n}"] = client.decile(n, 0, PARITY_DAYS, horizon=1,
                                           group_num=5)
    out["wire"] = kind.submit(Query("factors", 0, PARITY_DAYS,
                                    encoding="wire")).result(300)
    return out


@pytest.fixture(scope="module")
def both_servers():
    """The same seeded source and queries through the JAX server (on the
    CPU backend the tests run) and the port's (``device='cpu'``)."""
    from replication_of_minute_frequency_factor_tpu import serve as jserve
    from replication_of_minute_frequency_factor_tpu.telemetry import (
        Telemetry as JaxTelemetry)
    jsrc = jserve.SyntheticSource(n_days=PARITY_DAYS,
                                  n_tickers=PARITY_TICKERS,
                                  seed=PARITY_SEED)
    tsrc = SyntheticSource(n_days=PARITY_DAYS, n_tickers=PARITY_TICKERS,
                           seed=PARITY_SEED)
    jsrv = jserve.FactorServer(jsrc, names=PARITY_NAMES,
                               telemetry=JaxTelemetry(),
                               serve_cfg=jserve.ServeConfig())
    try:
        jans = _ask(jsrv.client(300), jsrv)
    finally:
        jsrv.close()
    tsrv = FactorServer(tsrc, names=PARITY_NAMES, telemetry=Telemetry(),
                        device="cpu")
    try:
        tans = _ask(tsrv.client(300), tsrv)
    finally:
        tsrv.close()
    return jsrc, tsrc, jans, tans


def test_synthetic_source_is_bitwise_the_jax_source(both_servers):
    jsrc, tsrc, _, _ = both_servers
    jb, jm = jsrc.slab(0, PARITY_DAYS)
    tb, tm = tsrc.slab(0, PARITY_DAYS)
    assert jb.dtype == tb.dtype and jm.dtype == tm.dtype
    assert jb.tobytes() == tb.tobytes() and jm.tobytes() == tm.tobytes()
    assert jsrc.codes == tsrc.codes and jsrc.days == tsrc.days
    assert jsrc.session.name == tsrc.session.name


def test_served_factors_match_the_jax_server(both_servers):
    """Exposures within tests/test_parity.py's comparator, the JAX value
    in the reference's place; NaN positions identical."""
    from test_parity import _check
    _, tsrc, jans, tans = both_servers
    j, t = jans["factors"], tans["factors"]
    assert set(j) == set(t)
    assert (j["days"], j["codes"]) == (t["days"], t["codes"])
    failures = []
    for n in PARITY_NAMES:
        a = np.asarray(t["exposures"][n], np.float32)
        b = np.asarray(j["exposures"][n], np.float32)
        assert a.shape == b.shape == (PARITY_DAYS, PARITY_TICKERS)
        assert np.array_equal(np.isnan(a), np.isnan(b)), n
        for d in range(PARITY_DAYS):
            for k, code in enumerate(tsrc.codes):
                _check(f"serve/d{d}", n, code, b[d, k], a[d, k], False,
                       failures)
    assert not failures, "\n".join(failures[:40])


def test_served_ic_matches_the_jax_server(both_servers):
    _, _, jans, tans = both_servers
    for n in PARITY_NAMES:
        j, t = jans[f"ic/{n}"], tans[f"ic/{n}"]
        assert set(j) == set(t)
        for key in ("ic", "rank_ic"):
            a = np.asarray(t[key], np.float64)
            b = np.asarray(j[key], np.float64)
            assert np.array_equal(np.isnan(a), np.isnan(b)), (n, key)
            ok = ~np.isnan(b)
            np.testing.assert_allclose(a[ok], b[ok], rtol=IC_RTOL,
                                       atol=IC_ATOL, err_msg=f"{n}/{key}")


def test_decile_counts_bitwise_where_the_exposures_are(both_servers):
    """On every factor whose served exposures are bitwise between the
    packages, the decile counts are bitwise too (at least one such factor
    is among the parity names), and the mean forward returns agree."""
    _, _, jans, tans = both_servers
    bitwise = [n for n in PARITY_NAMES
               if np.array_equal(
                   np.asarray(jans["factors"]["exposures"][n], np.float32),
                   np.asarray(tans["factors"]["exposures"][n], np.float32),
                   equal_nan=True)]
    assert bitwise
    for n in bitwise:
        j, t = jans[f"decile/{n}"], tans[f"decile/{n}"]
        assert set(j) == set(t)
        assert t["counts"] == j["counts"], n
        a = np.asarray(t["mean_fwd_ret"], np.float64)
        b = np.asarray(j["mean_fwd_ret"], np.float64)
        assert np.array_equal(np.isnan(a), np.isnan(b)), n
        ok = ~np.isnan(b)
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-5, atol=1e-7)


def test_wire_payloads_decode_alike_in_both_packages(both_servers):
    """Each server's packed result-wire payload decodes to the same
    values under both packages' decoders, and the two decoded blocks
    agree like the raw exposures do (same NaN lanes)."""
    from replication_of_minute_frequency_factor_tpu.data import (
        result_wire as jrw)
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as trw)
    _, _, jans, tans = both_servers
    decoded = {}
    for label, ans in (("jax", jans["wire"]), ("port", tans["wire"])):
        assert ans["wire"] is True
        assert ans["names"] == list(PARITY_NAMES)
        args = (np.asarray(ans["payload"]), ans["n_factors"], ans["days"],
                ans["tickers"], ans["spill_rows"])
        jd, _ = jrw.decode_block(*args)
        td, _ = trw.decode_block(*args)
        assert jd.tobytes() == td.tobytes(), label
        decoded[label] = td
    assert tans["wire"]["spill_rows"] == jans["wire"]["spill_rows"]
    a, b = decoded["port"], decoded["jax"]
    assert np.array_equal(np.isnan(a), np.isnan(b))
    n_bitwise = 0
    for i, n in enumerate(PARITY_NAMES):
        raw = np.asarray(jans["factors"]["exposures"][n], np.float32)
        port_raw = np.asarray(tans["factors"]["exposures"][n], np.float32)
        if raw.tobytes() == port_raw.tobytes():
            # the same exposures must encode to the same slice
            assert a[i].tobytes() == b[i].tobytes(), n
            n_bitwise += 1
            continue
        # exposures that differ in their last bits may land in
        # neighbouring quantisation steps of the pinned bounds
        scale = max(float(np.nanmax(np.abs(raw))), 1e-12)
        ok = ~np.isnan(b[i])
        np.testing.assert_allclose(a[i][ok], b[i][ok], rtol=0,
                                   atol=2e-2 * scale, err_msg=n)
    assert n_bitwise > 0
