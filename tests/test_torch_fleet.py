"""The port's fleet, held to tests/test_fleet.py and to the JAX package's
fleet on the same ``SyntheticSource``.

The port's replicas run in this process on an explicit CPU device list,
``[torch.device('cpu')] * 8``, as the JAX package's replicas run on the 8
virtual CPU devices of tests/conftest.py: ``partition_devices`` slices
either list the same way. Each test of tests/test_fleet.py whose subject
exists in the port runs here against the port (the bench smoke does not:
the JAX package's bench is not ported), and where the two frameworks can
be compared they are: the rendezvous owner of every key of a 1000-key
sweep (numpy and torch integer keys included), the owner and the
coalescing of a range, the replica the ladder demotes, the per-replica
dispatch split, the health rollup's shape and the CLI demo's summary.
Routed answers are bitwise the standalone port server's, and held to the
JAX fleet's at tests/test_parity.py's comparator (the one
tests/test_torch_serve.py holds the two servers to). Where the JAX tests
read ``xla.compiles``, these read ``kernels.build_count`` (kernel-library
builds and loads), and the executable cache's key count beside it.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu import fleet as jfleet
from replication_of_minute_frequency_factor_tpu import serve as jserve
from replication_of_minute_frequency_factor_tpu.fleet import (
    router as jrouter)
from replication_of_minute_frequency_factor_tpu_torch import kernels
from replication_of_minute_frequency_factor_tpu_torch.fleet import (
    FactorFleet, FleetConfig, FleetShedError, partition_devices,
    serve_fleet_frontdoor, serve_fleet_http)
from replication_of_minute_frequency_factor_tpu_torch.fleet import router
from replication_of_minute_frequency_factor_tpu_torch.serve import (
    FactorServer, Query, ServeConfig, SyntheticSource)
from replication_of_minute_frequency_factor_tpu_torch.serve.engine import (
    ServeEngine)
from replication_of_minute_frequency_factor_tpu_torch.stream import (
    StreamEngine)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry, aggregate)

NAMES = ("vol_return1min", "mmt_am")

N_DEVICES = 8
CPUS = [torch.device("cpu")] * N_DEVICES


def _src():
    return SyntheticSource(n_days=8, n_tickers=24, seed=3)


def _fleet(n=2, names=NAMES, start=True, stream=False, fleet_cfg=None,
           **scfg):
    return FactorFleet(_src(), n, names=names,
                       serve_cfg=ServeConfig(**scfg), fleet_cfg=fleet_cfg,
                       stream=stream, start=start, devices=CPUS)


def _jax_fleet(n=2, names=NAMES, start=True, stream=False, fleet_cfg=None,
               **scfg):
    src = jserve.SyntheticSource(n_days=8, n_tickers=24, seed=3)
    return jfleet.FactorFleet(
        src, n, names=names, serve_cfg=jserve.ServeConfig(**scfg),
        fleet_cfg=(jfleet.FleetConfig(**vars(fleet_cfg))
                   if fleet_cfg is not None else None),
        stream=stream, start=start)


def _day_minutes(src, lo, hi):
    bars, mask = src.slab(0, 1)
    return (np.ascontiguousarray(np.swapaxes(bars[0][:, lo:hi], 0, 1)),
            np.ascontiguousarray(mask[0][:, lo:hi].T))


def _boom(*a, **k):
    raise RuntimeError("injected replica failure")


def _same_bits(a, b) -> bool:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _hold_to_jax(got, want, codes):
    """Port exposures against the JAX fleet's at tests/test_parity.py's
    comparator (the JAX value in the reference's place), NaN positions
    identical."""
    from test_parity import _check
    failures = []
    for n in got:
        a = np.asarray(got[n], np.float32)
        b = np.asarray(want[n], np.float32)
        assert a.shape == b.shape
        assert np.array_equal(np.isnan(a), np.isnan(b)), n
        for d in range(a.shape[0]):
            for k, code in enumerate(codes):
                _check(f"fleet/d{d}", n, code, b[d, k], a[d, k], False,
                       failures)
    assert not failures, "\n".join(failures[:40])


# --------------------------------------------------------------------------
# device groups
# --------------------------------------------------------------------------


def test_partition_devices_disjoint_and_uniform(monkeypatch):
    """The JAX partition gate on the port: uniform groups sliced out of
    the list in order (positions disjoint; distinct cards disjoint as
    devices), remainder idle, over-subscription and zero refused, the
    groups' sizes JAX's on its 8 virtual devices. With no list the
    default is every visible card, and with none visible it raises."""
    import jax
    cards = [torch.device("cuda", i) for i in range(N_DEVICES)]
    for n in (1, 2, 3, 4, 8):
        want = [len(g) for g in jfleet.partition_devices(n)]
        for devices in (CPUS, cards):
            groups = partition_devices(n, devices)
            assert [len(g) for g in groups] == want
            assert [d for g in groups for d in g] == \
                devices[:n * (N_DEVICES // n)]
        seen = [d for g in partition_devices(n, cards) for d in g]
        assert len(seen) == len(set(seen))
    assert len(jax.devices()) == N_DEVICES
    with pytest.raises(ValueError, match="disjoint"):
        partition_devices(N_DEVICES + 1, CPUS)
    with pytest.raises(ValueError, match=">= 1"):
        partition_devices(0, CPUS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        partition_devices(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert partition_devices(3) == [(torch.device("cuda", i),)
                                    for i in range(3)]


# --------------------------------------------------------------------------
# affinity + coalescing (the routing contract)
# --------------------------------------------------------------------------


def test_route_order_matches_jax_over_a_key_sweep():
    """``route_order`` names the same replicas as the JAX router for
    1000 random ranges and the intraday key, at 2, 3, 4 and 8 replicas,
    whatever integer type the key was given in: the port hashes the
    Python-int form, as the JAX router does for the ``(start, end)`` of
    a parsed query."""
    rng = np.random.default_rng(11)
    starts = rng.integers(0, 5000, 1000)
    spans = rng.integers(1, 300, 1000)
    for n in (2, 3, 4, 8):
        pod = _fleet(n=n, start=False, hbm_sample_period_s=0,
                     timeline_sample_period_s=0)
        jpod = _jax_fleet(n=n, start=False, hbm_sample_period_s=0,
                          timeline_sample_period_s=0)
        try:
            cands, jcands = pod.replicas, jpod.replicas
            keys = [(int(a), int(a + b)) for a, b in zip(starts, spans)]
            for i, key in enumerate(keys):
                want = [r.label for r in jpod.router.route_order(
                    key, jcands)]
                typed = (key, (np.int64(key[0]), np.int64(key[1])),
                         (np.int32(key[0]), np.uint16(key[1])),
                         (torch.tensor(key[0]), torch.tensor(key[1])))
                for k in typed[:1] if i % 4 else typed:
                    got = [r.label for r in pod.router.route_order(
                        k, cands)]
                    assert got == want, (n, k)
            for q in (Query("intraday"), Query("factors", 2, 6)):
                got = pod.router.route_order(pod.router.routing_key(q),
                                             cands)
                want = jpod.router.route_order(
                    jpod.router.routing_key(jserve.Query(
                        q.kind, q.start, q.end)), jcands)
                assert [r.label for r in got] == [r.label for r in want]
        finally:
            pod.close()
            jpod.close()
    # the trap the canonical key closes: numpy 2 prints its integers as
    # np.int64(2), so the JAX hash of a numpy key is another hash
    if repr(np.int64(2)) != "2":
        labels = [f"r{i}" for i in range(8)]
        assert any(
            jrouter._rendezvous_order(labels, (np.int64(a), np.int64(b)))
            != jrouter._rendezvous_order(labels, (int(a), int(b)))
            for a, b in zip(starts[:50], starts[:50] + 1))
        assert all(
            router._rendezvous_order(labels, (np.int64(a), np.int64(b)))
            == jrouter._rendezvous_order(labels, (int(a), int(b)))
            for a, b in zip(starts[:50], starts[:50] + 1))


def test_same_range_queries_coalesce_on_one_replica(monkeypatch):
    """THE affinity gate: K same-range queries through the router land
    on ONE replica (the one the JAX fleet's rendezvous names) and drain
    as ONE coalesced dispatch there — the other replica dispatches
    nothing; the block lives on the owner's ``devices[0]``; the answers
    are bitwise the standalone port server's and within the parity
    comparator of the JAX fleet's. Runs with the runtime lock-assert
    twin armed."""
    monkeypatch.setenv("MFF_LOCK_ASSERT", "1")
    k = 6
    fleet = _fleet(start=False)
    try:
        futs = [fleet.submit(Query("factors", 2, 6, names=("mmt_am",)))
                for _ in range(k)]
        fleet.start()
        results = [f.result(120) for f in futs]
        for r in results[1:]:
            assert _same_bits(r["exposures"]["mmt_am"],
                              results[0]["exposures"]["mmt_am"])
        disp = {r.label: r.telemetry.registry.counter_total(
            "serve.dispatches") for r in fleet.replicas}
        coal = {r.label: r.telemetry.registry.counter_value(
            "serve.coalesced_dispatches") for r in fleet.replicas}
        owners = [l_ for l_, d in disp.items() if d > 0]
        assert len(owners) == 1, disp
        owner_label = owners[0]
        assert disp[owner_label] == 1 and coal[owner_label] == 1
        owner = next(r for r in fleet.replicas if r.label == owner_label)
        assert owner.telemetry.registry.counter_value(
            "serve.coalesced_requests") == k
        assert fleet.router.route_order((2, 6))[0].label == owner_label
        preg = fleet.telemetry.registry
        assert preg.counter_value("fleet.affinity", outcome="hit") == k - 1
        assert preg.counter_value("fleet.routed",
                                  replica=owner_label) == k
        block = owner.server.cache.get((2, 6))
        assert {t.device for t in block.values()} == {owner.devices[0]}
        routed = results[0]
    finally:
        fleet.close()
    with FactorServer(_src(), names=NAMES, device="cpu",
                      telemetry=Telemetry()) as alone:
        direct = alone.submit(Query("factors", 2, 6,
                                    names=("mmt_am",))).result(120)
    assert _same_bits(routed["exposures"]["mmt_am"],
                      direct["exposures"]["mmt_am"])
    jpod = _jax_fleet(start=False)
    try:
        jfuts = [jpod.submit(jserve.Query("factors", 2, 6,
                                          names=("mmt_am",)))
                 for _ in range(k)]
        jpod.start()
        jres = [f.result(120) for f in jfuts]
        jdisp = {r.label: r.telemetry.registry.counter_total(
            "serve.dispatches") for r in jpod.replicas}
        assert jdisp == disp
        assert jpod.telemetry.registry.counter_value(
            "fleet.affinity", outcome="hit") == k - 1
    finally:
        jpod.close()
    _hold_to_jax(routed["exposures"], jres[0]["exposures"], routed["codes"])


def test_distinct_ranges_spread_and_reuse_their_owner():
    """Different keys land on their rendezvous owners (the JAX fleet's),
    and a repeated key returns to its owner warm: one cache hit a key,
    no key added to any executable cache, no kernel library built."""
    fleet = _fleet()
    jpod = _jax_fleet(start=False, hbm_sample_period_s=0,
                      timeline_sample_period_s=0)
    try:
        keys = [(0, 2), (2, 4), (4, 6), (6, 8)]
        for k in keys:
            fleet.submit(Query("factors", *k)).result(120)
        for k in keys:
            routes = [t for t in fleet.telemetry._requests
                      if t["op"] == "route" and t["data"]["key"] == list(k)]
            assert routes[-1]["data"]["replica"] == \
                jpod.router.route_order(k)[0].label
        built = kernels.build_count()
        misses = sum(r.telemetry.registry.counter_value(
            "serve.executables", outcome="miss") for r in fleet.replicas)
        for k in keys:
            fleet.submit(Query("factors", *k)).result(120)
        assert kernels.build_count() == built
        assert sum(r.telemetry.registry.counter_value(
            "serve.executables", outcome="miss")
            for r in fleet.replicas) == misses
        hits = sum(r.telemetry.registry.counter_value(
            "serve.cache", outcome="hit") for r in fleet.replicas)
        assert hits == len(keys)
    finally:
        fleet.close()
        jpod.close()


# --------------------------------------------------------------------------
# shed/degrade ladder (the acceptance criterion, end to end)
# --------------------------------------------------------------------------


def test_breaker_demotion_pod_keeps_serving_then_recovers(tmp_path):
    """A replica whose breaker is forced open is demoted from routing
    (flight dump naming it), the pod keeps answering the SAME range
    through the remaining replica, and the half-open ladder restores the
    healed replica — end to end, with the same replica demoted and
    restored as in the JAX fleet under the same injection."""
    outcome = {}
    for tag, make, q_of in (
            ("port", _fleet, Query),
            ("jax", _jax_fleet, jserve.Query)):
        flight = tmp_path / tag
        flight.mkdir()
        pod = make(start=True, breaker_threshold=1,
                   breaker_cooldown_s=0.4, flight_dir=str(flight),
                   fleet_cfg=FleetConfig(demote_cooldown_s=0.2))
        try:
            key = (0, 4)
            owner = pod.router.route_order(key)[0]
            other = next(r for r in pod.replicas if r is not owner)
            owner.server.engine.build_block = _boom
            with pytest.raises(RuntimeError, match="injected"):
                pod.submit(q_of("factors", *key)).result(120)
            assert owner.server.breaker_state() == "open"
            r = pod.submit(q_of("factors", *key)).result(120)
            assert "exposures" in r
            health = pod.health()
            assert health["ok"] is True
            assert health["pod"]["live"] == 1
            assert health["pod"]["demoted"] == [owner.label]
            assert health["pod"]["reasons"][owner.label] == "breaker"
            assert health["replicas"][owner.label]["replica"]["breaker"] \
                in ("open", "half_open")
            assert other.telemetry.registry.counter_total(
                "serve.dispatches") == 1
            dumps = [f for f in os.listdir(flight) if "fleet_demote" in f]
            assert dumps, os.listdir(flight)
            content = open(flight / dumps[0]).read()
            assert owner.label in content and "breaker" in content
            assert pod.telemetry.registry.counter_value(
                "fleet.demotions", replica=owner.label,
                reason="breaker") == 1
            if tag == "port":
                owner.server.engine = ServeEngine(
                    owner.server.names, telemetry=owner.telemetry,
                    executables=owner.server.executables, device="cpu")
            else:
                from replication_of_minute_frequency_factor_tpu.serve.engine import (  # noqa: E501
                    ServeEngine as JaxServeEngine)
                owner.server.engine = JaxServeEngine(
                    owner.server.names, telemetry=owner.telemetry,
                    executables=owner.server.executables)
            time.sleep(0.5)
            r2 = pod.submit(q_of("factors", *key)).result(120)
            assert "exposures" in r2
            health = pod.health()
            assert health["pod"]["live"] == 2
            assert health["pod"]["demoted"] == []
            assert pod.telemetry.registry.counter_value(
                "fleet.restores", replica=owner.label) == 1
            outcome[tag] = (owner.label, other.label, r["exposures"],
                            r2["exposures"], r["codes"])
        finally:
            pod.close()
    assert outcome["port"][:2] == outcome["jax"][:2]
    for i in (2, 3):
        _hold_to_jax(outcome["port"][i], outcome["jax"][i],
                     outcome["port"][4])


@pytest.mark.parametrize("transport", ["legacy", "edge"])
def test_pod_sheds_503_with_retry_after_only_when_all_out(transport):
    """Pod-level shed is the LAST resort: with every replica demoted the
    router raises FleetShedError (Retry-After derived from the demotion
    cooldown) and the front door, legacy or edge, answers 503 +
    Retry-After — while a single demotion never sheds the pod."""
    fleet = _fleet(start=True, breaker_threshold=1,
                   breaker_cooldown_s=30.0,
                   fleet_cfg=FleetConfig(demote_cooldown_s=30.0))
    door = None
    try:
        key = (0, 4)
        for r in fleet.replicas:
            r.server.engine.build_block = _boom
        with pytest.raises(RuntimeError, match="injected"):
            fleet.submit(Query("factors", *key)).result(120)
        assert fleet.health()["ok"] is True  # one demotion: still live
        with pytest.raises(RuntimeError, match="injected"):
            fleet.submit(Query("factors", *key)).result(120)
        with pytest.raises(FleetShedError) as e:
            fleet.submit(Query("factors", *key))
        assert e.value.retry_after_s and e.value.retry_after_s > 0
        assert fleet.health()["ok"] is False
        door = serve_fleet_frontdoor(fleet, transport=transport)
        port = door.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/query",
            data=json.dumps({"kind": "factors", "start": 0,
                             "end": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as he:
            urllib.request.urlopen(req, timeout=60)
        assert he.value.code == 503
        assert json.loads(he.value.read())["shed"] is True
        assert int(he.value.headers["Retry-After"]) >= 1
    finally:
        if door is not None:
            door.shutdown()
        fleet.close()


# --------------------------------------------------------------------------
# ingest fan-out (failure isolation)
# --------------------------------------------------------------------------


def test_ingest_fanout_isolates_failed_leg_and_excludes_it():
    """One replica's ingest failure must not poison the others: the
    failed leg is surfaced alone, the healthy carry advances, the
    broken replica is excluded from the next fan-out (demoted), and
    intraday queries keep serving from the healthy replica — bitwise a
    standalone StreamEngine fed the same minutes."""
    fleet = _fleet(stream=True, breaker_threshold=1,
                   breaker_cooldown_s=30.0,
                   fleet_cfg=FleetConfig(demote_cooldown_s=30.0))
    try:
        broken, healthy = fleet.replicas
        broken.server.stream_engine.ingest_minutes = _boom
        bars, present = _day_minutes(fleet.source, 0, 2)
        res = fleet.ingest(bars, present)
        assert res["minute"] == 2
        assert res["failed"] == [broken.label]
        assert res["replicas"][healthy.label]["ok"] is True
        assert "injected" in res["replicas"][broken.label]["error"]
        assert healthy.server.stream_engine.minutes == 2
        assert broken.server.stream_engine.minutes == 0
        bars2, present2 = _day_minutes(fleet.source, 2, 4)
        res2 = fleet.ingest(bars2, present2)
        assert res2["minute"] == 4
        assert res2["replicas"][broken.label].get("skipped") is True
        assert res2["failed"] == [broken.label]
        health = fleet.health()
        assert health["pod"]["demoted"] == [broken.label]
        assert health["pod"]["stream_minute"] == 4
        assert health["pod"]["stream_minute_skew"] == 4
        assert broken.server.stream_engine.cursor()["minute"] == 0
        snap = fleet.submit(Query("intraday")).result(120)
        assert snap["minute"] == 4
    finally:
        fleet.close()
    eng = StreamEngine(24, names=NAMES, telemetry=Telemetry(),
                       device="cpu")
    eng.ingest_minutes(bars, present)
    eng.ingest_minutes(bars2, present2)
    exp, ready = (t.numpy() for t in eng.snapshot())
    for i, n in enumerate(NAMES):
        assert _same_bits(snap["exposures"][n], exp[i])
        assert snap["ready"][n] == ready[i].tolist()


def test_ingest_fanout_sheds_only_when_every_leg_fails():
    fleet = _fleet(stream=True, breaker_threshold=1,
                   breaker_cooldown_s=30.0,
                   fleet_cfg=FleetConfig(demote_cooldown_s=30.0))
    try:
        for r in fleet.replicas:
            r.server.stream_engine.ingest_minutes = _boom
        bars, present = _day_minutes(fleet.source, 0, 1)
        with pytest.raises(FleetShedError, match="every stream"):
            fleet.ingest(bars, present)
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# pod metrics fold + trace propagation
# --------------------------------------------------------------------------


def test_pod_counter_totals_equal_per_replica_sums():
    """The exact-merge contract, in process: every pod counter equals
    the control-plane + per-replica sum, and the routed/dispatch totals
    and their split over replicas are the JAX fleet's."""
    keys = ((0, 2), (2, 4), (0, 2))
    fleet = _fleet()
    try:
        for k in keys:
            fleet.submit(Query("factors", *k)).result(120)
        merged = fleet.pod_registry()
        snap = merged.snapshot()
        regs = ([fleet.telemetry.registry]
                + [r.telemetry.registry for r in fleet.replicas])
        assert snap["counters"], "pod fold lost every counter"
        for key, total in snap["counters"].items():
            per = sum(reg.snapshot()["counters"].get(key, 0.0)
                      for reg in regs)
            assert abs(per - total) <= 1e-9 * max(1.0, abs(total)), key
        assert merged.counter_total("fleet.routed") == 3
        assert merged.counter_total("serve.dispatches") == 2
        split = {r.label: r.telemetry.registry.counter_total(
            "serve.dispatches") for r in fleet.replicas}
    finally:
        fleet.close()
    jpod = _jax_fleet()
    try:
        for k in keys:
            jpod.submit(jserve.Query("factors", *k)).result(120)
        jmerged = jpod.pod_registry()
        assert jmerged.counter_total("fleet.routed") == 3
        assert jmerged.counter_total("serve.dispatches") == 2
        assert {r.label: r.telemetry.registry.counter_total(
            "serve.dispatches") for r in jpod.replicas} == split
    finally:
        jpod.close()


def test_trace_id_round_trips_router_to_replica():
    """One request is reconstructable across the hop: the caller's
    trace ID comes back in the answer, the router's route record
    names the replica under the SAME ID, and the replica's request
    record carries it too."""
    fleet = _fleet()
    try:
        tid = "fleet-trace-0001"
        r = fleet.submit(Query("factors", 0, 2),
                         trace_id=tid).result(120)
        assert r["trace_id"] == tid
        routes = [t for t in fleet.telemetry._requests
                  if t["trace_id"] == tid]
        assert len(routes) == 1 and routes[0]["op"] == "route"
        owner_label = routes[0]["data"]["replica"]
        owner = next(rep for rep in fleet.replicas
                     if rep.label == owner_label)
        replica_side = [t for t in owner.telemetry._requests
                        if t["trace_id"] == tid]
        assert len(replica_side) == 1
        assert replica_side[0]["op"] == "factors"
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# front door + health + bundles + CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["legacy", "edge"])
def test_fleet_http_front_door_round_trip(transport):
    """One HTTP surface, through either door: routed query (trace
    echoed, the body bitwise the in-process answer), per-replica + pod
    healthz (each replica lists its 4 devices), the pod-folded metrics in
    JSON and Prometheus text, ingest fan-out with the leg map."""
    fleet = _fleet(stream=True)
    door = None
    try:
        door = (serve_fleet_http(fleet)[0] if transport == "legacy"
                else serve_fleet_frontdoor(fleet, transport="edge"))
        port = door.server_address[1]

        def post(doc, path="/v1/query", tid=None):
            headers = {"Content-Type": "application/json"}
            if tid:
                headers["X-Trace-Id"] = tid
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(doc).encode(), headers=headers)
            with urllib.request.urlopen(req, timeout=120) as resp:
                return (resp.status, dict(resp.headers),
                        json.loads(resp.read()))

        status, headers, r = post({"kind": "factors", "start": 0,
                                   "end": 2, "names": ["mmt_am"]},
                                  tid="pod-req-1")
        assert status == 200 and headers["X-Trace-Id"] == "pod-req-1"
        assert r["trace_id"] == "pod-req-1"
        assert list(r["exposures"]) == ["mmt_am"]
        in_proc = fleet.submit(Query("factors", 0, 2,
                                     names=("mmt_am",))).result(120)
        assert _same_bits(r["exposures"]["mmt_am"],
                          in_proc["exposures"]["mmt_am"])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            h = json.loads(resp.read())
        assert h["ok"] and h["pod"]["live"] == 2
        assert set(h["replicas"]) == {"r0", "r1"}
        for label, rep in h["replicas"].items():
            assert rep["replica"]["label"] == label
            assert rep["replica"]["devices"] == ["cpu"] * (N_DEVICES // 2)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/metrics",
                timeout=30) as resp:
            snap = json.loads(resp.read())
        assert "fleet.routed{replica=r0}" in snap["counters"] \
            or "fleet.routed{replica=r1}" in snap["counters"]
        for url, hdrs in (("/v1/metrics", {"Accept": "text/plain"}),
                          ("/v1/metrics?format=prometheus", {})):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{url}",
                                         headers=hdrs)
            with urllib.request.urlopen(req, timeout=30) as resp:
                text = resp.read().decode()
            assert "fleet_routed_total" in text
            assert "serve_dispatches_total" in text
        bars, present = _day_minutes(fleet.source, 0, 1)
        status, _hdr, res = post({"bars": bars.tolist(),
                                  "present": present.tolist()},
                                 path="/v1/ingest")
        assert status == 200 and res["minute"] == 1
        assert res["failed"] == []
        assert all(leg["ok"] for leg in res["replicas"].values())
    finally:
        if door is not None:
            door.shutdown()
        fleet.close()


def _shape(x):
    """A JSON value's shape: dicts by their keys, lists by their items'
    shapes, scalars by kind (ints and floats alike, None apart)."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return type(x).__name__
    return "number"


def test_health_rollup_has_the_jax_shape():
    """After the same query and ingest, the pod health has the JAX
    fleet's keys and shapes everywhere but where a device is named (its
    name is the framework's) and the factor-health detail a replica
    without a block reports."""
    shapes = []
    for make, q_of in ((_fleet, Query), (_jax_fleet, jserve.Query)):
        pod = make(stream=True)
        try:
            pod.submit(q_of("factors", 0, 2)).result(120)
            pod.ingest(*_day_minutes(pod.source, 0, 1))
            h = json.loads(json.dumps(pod.health()))
        finally:
            pod.close()
        for rep in h["replicas"].values():
            rep["replica"]["devices"] = len(rep["replica"]["devices"])
            rep.pop("factor_health")
        h["pod"].pop("factor_health")
        shapes.append(_shape(h))
    assert shapes[0] == shapes[1]


def test_replica_bundles_stamp_and_aggregate(tmp_path):
    """Each replica writes a bundle stamped with its identity; the
    port's aggregate folds them with every counter total exact, and the
    JAX package's validator accepts each bundle and the pod bundle."""
    from replication_of_minute_frequency_factor_tpu.telemetry.validate import (
        validate_dir)
    fleet = _fleet()
    try:
        for k in ((0, 2), (2, 4), (4, 6)):
            fleet.submit(Query("factors", *k)).result(120)
        dirs = []
        for r in fleet.replicas:
            d = str(tmp_path / r.label)
            r.write_bundle(d)
            dirs.append(d)
            with open(os.path.join(d, "manifest.json")) as fh:
                m = json.load(fh)
            assert (m["process_index"], m["host"]) == (r.index, r.label)
            assert validate_dir(d)["ok"]
    finally:
        fleet.close()
    pod = str(tmp_path / "pod")
    got = aggregate.aggregate_dirs(dirs, pod)
    assert got["ok"] and got["counter_totals"]["mismatched"] == 0
    reg = aggregate.registry_of(aggregate.load_bundle(pod))
    assert reg.counter_total("serve.dispatches") == 3
    assert validate_dir(pod)["ok"]


def test_probe_and_hbm_signals_on_the_cpu():
    """The liveness probe is a put on the replica's device (true on the
    CPU); the CPU has no memory reading, so its HBM signal is
    unavailable and never demotes."""
    fleet = _fleet()
    try:
        for r in fleet.replicas:
            assert r.probe_device() is True
            r.telemetry.hbm.sample("test", force=True)
            assert r.hbm_bytes() == (0.0, False)
            assert not fleet.policy._hbm_over(r)
        assert repr(fleet.replicas[0]) == \
            f"Replica(r0, devices={['cpu'] * (N_DEVICES // 2)})"
    finally:
        fleet.close()


def test_cli_fleet_demo(capsys):
    """``serve --fleet 2 --demo K --device cpu``: the summary's keys and
    counts are the JAX CLI's on the same synthetic source, but
    ``compiles`` (XLA compiles there, kernel-library builds here: none
    on the CPU)."""
    from replication_of_minute_frequency_factor_tpu.__main__ import (
        main as jax_main)
    from replication_of_minute_frequency_factor_tpu_torch.__main__ import (
        main)
    argv = ["serve", "--fleet", "2", "--demo", "6",
            "--synthetic-days", "6", "--synthetic-tickers", "16",
            "--factors", "vol_return1min,mmt_am"]
    outs = []
    for fn, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        assert fn(argv + extra) == 0
        outs.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    out, jout = outs
    assert set(out) == set(jout)
    assert out["compiles"] == 0
    out.pop("compiles"), jout.pop("compiles")
    assert out == jout
    assert out["demo_requests"] == 6 and out["fleet"] == 2
    assert out["live_replicas"] == 2 and out["routed"] == 6
    assert sum(out["per_replica_dispatches"].values()) == out["dispatches"]


# --------------------------------------------------------------------------
# pod SLO plane
# --------------------------------------------------------------------------


def test_fleet_slo_plane_and_pod_staleness():
    """The fleet runs its own pod-level SLO plane (``pod_availability``
    + ``pod_freshness`` on a streaming fleet), the router timeline
    samples the derived pod signals, the health rollup carries the
    WORST replica staleness, and the front door serves ``/v1/slo`` and
    ``/v1/timeline``."""
    fleet = _fleet(stream=True)
    httpd = None
    try:
        fleet.submit(Query("factors", 0, 2)).result(120)
        bars, present = _day_minutes(fleet.source, 0, 2)
        fleet.ingest(bars, present)
        frame = fleet.timeline.sample()
        s = fleet.sloplane.summary()
        assert s["available"] and s["frames"] >= 1
        assert {"pod_availability",
                "pod_freshness"} <= set(s["objectives"])
        assert s["alerts"] == 0
        assert "gauge:fleet.live_replicas" in frame["series"]
        assert "gauge:fleet.stream_staleness_s" in frame["series"]
        h = fleet.health()
        assert isinstance(h["pod"]["stream_staleness_s"], float)
        assert h["pod"]["stream_staleness_s"] >= 0.0
        httpd, _t = serve_fleet_http(fleet)
        port = httpd.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/slo", timeout=30) as resp:
            doc = json.loads(resp.read())
        assert set(doc["slo"]["objectives"]) == set(s["objectives"])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/slo?format=prometheus",
                timeout=30) as resp:
            text = resp.read().decode()
        assert "slo_burn_rate" in text and "fleet_routed" not in text
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/timeline?name=fleet.",
                timeout=30) as resp:
            t = json.loads(resp.read())
        assert t["count"] >= 1 and len(t["frames"]) == t["count"]
        assert all("fleet." in k
                   for f in t["frames"] for k in f["series"])
    finally:
        if httpd is not None:
            httpd.shutdown()
        fleet.close()
