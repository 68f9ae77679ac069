"""The port's ``research/`` and the server's research mode, held to the
JAX package's (tests/test_research.py, tests/test_markets.py's reload).

* ``host_forward_returns``, ``genome_name`` and ``data_fingerprint``:
  equal to the JAX package's, bit for bit.
* Records: a record either package writes loads in the other, with the
  same name and description; a corrupted record is refused.
* ``generation_stats`` against JAX's on the same genomes (a population
  over the ops of bounded conditioning, tests/test_torch_search.py):
  NaN positions identical, the fitness and IC columns within the
  interpreter tolerance, the fitness column bitwise ``|mean_ic|``. The
  rank-IC and spread columns are step functions of the exposures'
  order, which an ulp changes where two exposures nearly tie (a mean of
  a day-constant series is rounded per ticker), so they are held within
  tolerance on the candidates whose port and JAX exposures order every
  date alike (``torch_cases.same_order``; the others are counted), and
  on JAX's own exposures the port's stats body gives JAX's stats.
* The GA loop: the port's ``DiscoveryEngine.evolve``, fed JAX's
  ``generation_fitness`` outputs by a test-local stub of its generation
  callable, gives the JAX engine's genome, history and best stats bit
  for bit under the same ``np.random.default_rng(seed)``.
* The device top-k: JAX's ``lax.top_k`` selection on the same fitness
  (ties and NaN included), and the host argsort's first ``n_elite``.
* The server, with ``device="cpu"``: every behaviour of
  tests/test_research.py's serve section (discover end to end with one
  sync a generation and nothing built in the loop, idempotent
  registration and cache invalidation, validation, the intraday
  refusal, discover without research mode, the HTTP and edge routes)
  and the reload from ``research_dir``. Where the JAX tests read
  ``xla.compiles``, these read ``serve.executables{outcome=miss}``.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import torch

from replication_of_minute_frequency_factor_tpu import search as J
from replication_of_minute_frequency_factor_tpu.research import (
    fitness as JF)
from replication_of_minute_frequency_factor_tpu.research import (
    registry as JR)
from replication_of_minute_frequency_factor_tpu.research.evolve import (
    DiscoveryEngine as JDiscoveryEngine)
from replication_of_minute_frequency_factor_tpu.telemetry import (
    Telemetry as JTelemetry)
from replication_of_minute_frequency_factor_tpu_torch import search as P
from replication_of_minute_frequency_factor_tpu_torch.data import wire
from replication_of_minute_frequency_factor_tpu_torch.models import (
    registry as models_registry)
from replication_of_minute_frequency_factor_tpu_torch.research import (
    DiscoveryEngine, genome_name, host_forward_returns, load_record,
    register_genome)
from replication_of_minute_frequency_factor_tpu_torch.research import (
    fitness as PF)
from replication_of_minute_frequency_factor_tpu_torch.research import (
    registry as PR)
from replication_of_minute_frequency_factor_tpu_torch.research.evolve import (
    resolve_skeleton)
from replication_of_minute_frequency_factor_tpu_torch.serve import (
    FactorServer, Query, ServeConfig, SyntheticSource, serve_frontdoor,
    serve_http)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry)

from torch_cases import bounded_population, same_order

#: the JAX package's interpreter tolerance (tests/test_search.py:38)
INTERP_RTOL, INTERP_ATOL = 2e-4, 1e-6

def _day_data(days=5, tickers=12, seed=0, horizon=1):
    """tests/test_research.py's slab."""
    rng = np.random.default_rng(seed)
    shape = (days, tickers, 240)
    close = 10.0 * np.exp(np.cumsum(
        rng.standard_normal(shape, dtype=np.float32)
        * np.float32(1e-3), axis=-1))
    open_ = close * (1 + rng.standard_normal(shape, dtype=np.float32)
                     * np.float32(1e-4))
    bars = np.stack([open_, np.maximum(open_, close) * 1.0002,
                     np.minimum(open_, close) * 0.9998, close,
                     (rng.integers(0, 1000, shape) * 100.0
                      ).astype(np.float32)], axis=-1).astype(np.float32)
    mask = rng.random(shape) > 0.05
    fwd_ret, fwd_valid = host_forward_returns(bars, mask, horizon)
    return bars, mask, fwd_ret, fwd_valid


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _restore_registries():
    """Each test's registrations leave the process's factor registry and
    discovered set as they were (other files check the registry's names,
    and may share this process)."""
    live = (models_registry.ALIASES, models_registry.FINALIZE_CLASSES,
            PR.DISCOVERED)
    saved = [dict(d) for d in live]
    yield
    for d, before in zip(live, saved):
        d.clear()
        d.update(before)


# --------------------------------------------------------------------------
# host-side copies: forward returns, names, fingerprints, records
# --------------------------------------------------------------------------


@pytest.mark.parametrize("horizon", [1, 2])
def test_host_forward_returns_is_bitwise_jax(horizon):
    bars, mask, _fr, _fv = _day_data(seed=1)
    mask[2, 3] = False       # a halted (day, ticker)
    mask[:, 5, 200:] = False  # early closes
    got = host_forward_returns(bars, mask, horizon)
    want = JF.host_forward_returns(bars, mask, horizon)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


def test_genome_name_and_fingerprint_equal_jax():
    bars, mask, _fr, _fv = _day_data(seed=2)
    assert PR.data_fingerprint(bars, mask) == JR.data_fingerprint(bars,
                                                                  mask)
    for skel in (P.DEFAULT_SKELETON, P.RICH_SKELETON, (0, 3, 4)):
        for g in P.random_population(np.random.default_rng(3), 8, skel):
            assert genome_name(g, skel) == JR.genome_name(g, skel)
            assert genome_name(list(g), list(skel)) == genome_name(g, skel)
    assert resolve_skeleton("default") == P.DEFAULT_SKELETON
    assert resolve_skeleton("rich") == P.RICH_SKELETON
    assert resolve_skeleton((0, 1)) == (0, 1)
    with pytest.raises(ValueError, match="unknown skeleton"):
        resolve_skeleton("nope")


def test_records_written_by_either_package_load_in_the_other(tmp_path):
    g = P.random_population(np.random.default_rng(11), 1)[0]
    rec = register_genome(g, fitness=0.4, mean_ic=-0.4, spread=0.01,
                          generations=3, pop=16, data_fingerprint="abc123",
                          save_dir=str(tmp_path / "port"))
    assert rec.name.startswith("disc_") and len(rec.name) == 15
    assert rec.description == P.describe(g)
    path = str(tmp_path / "port" / f"{rec.name}.json")
    back = JR.load_record(path)
    assert (back.name, back.genome, back.description) == \
        (rec.name, rec.genome, rec.description)
    assert back.data_fingerprint == "abc123" and back.fitness == 0.4
    g2 = P.random_population(np.random.default_rng(12), 1,
                             P.RICH_SKELETON)[0]
    jrec = JR.DiscoveredFactor(
        name=JR.genome_name(g2, J.RICH_SKELETON),
        genome=tuple(int(x) for x in g2), skeleton=J.RICH_SKELETON,
        fitness=0.3, mean_ic=0.3, mean_rank_ic=0.2, spread=0.001,
        generations=2, pop=8, data_fingerprint=None,
        description=J.describe(g2, J.RICH_SKELETON))
    jpath = JR.save_record(jrec, str(tmp_path / "jax"))
    mine = load_record(jpath)
    assert (mine.name, mine.genome, mine.skeleton, mine.description) == \
        (jrec.name, jrec.genome, jrec.skeleton, jrec.description)
    assert mine.to_json() == jrec.to_json()
    # registration is idempotent on the content-addressed name
    assert register_genome(g).name == rec.name


def test_corrupted_records_are_refused(tmp_path):
    g = P.random_population(np.random.default_rng(12), 1)[0]
    rec = register_genome(g, save_dir=str(tmp_path))
    path = str(tmp_path / f"{rec.name}.json")
    with open(path) as fh:
        doc = json.load(fh)
    doc["genome"][0] = (doc["genome"][0] + 1) % 12
    with open(path, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(ValueError, match="hashes to"):
        load_record(path)
    rec = register_genome(g, save_dir=str(tmp_path))
    with open(path) as fh:
        doc = json.load(fh)
    doc["description"] = "mean(open)"
    with open(path, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(ValueError, match="round-trip"):
        load_record(path)


def test_registered_kernel_computes_next_to_builtins():
    """A discovered factor computes through the port's
    ``compute_factors`` (DayContext + alias resolution), bitwise the
    evaluator on the same input, in the batched and the single-day
    layouts; its finalize class is ``batch_only``."""
    bars, mask, _fr, _fv = _day_data(seed=13)
    g = P.random_population(np.random.default_rng(14), 1)[0]
    rec = register_genome(g)
    out = models_registry.compute_factors(
        t(bars), t(mask), names=("vol_return1min", rec.name))
    ref = P.eval_programs(g[None], t(bars), t(mask))[0]
    assert torch.equal(torch.isnan(out[rec.name]), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(out[rec.name]),
                       torch.nan_to_num(ref))
    one = models_registry.compute_factors(t(bars[2]), t(mask[2]),
                                          names=(rec.name,))[rec.name]
    ref1 = P.eval_programs(g[None], t(bars[2:3]), t(mask[2:3]))[0, 0]
    assert one.shape == (bars.shape[1],)
    assert torch.equal(torch.nan_to_num(one), torch.nan_to_num(ref1))
    assert models_registry.FINALIZE_CLASSES[rec.name] == "batch_only"
    assert rec.name in PR.discovered_names()


# --------------------------------------------------------------------------
# the fused generation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("skeleton", ["default", "rich"])
def test_generation_stats_match_jax(skeleton):
    skel = resolve_skeleton(skeleton)
    bars, mask, fr, fv = _day_data(days=5, tickers=32, seed=3)
    g = bounded_population(4, 40, skel)
    want = np.asarray(JF.generation_stats(g, bars, mask, fr, fv, skel, 5,
                                          16))
    feats = P._features(t(bars), t(mask))
    got = PF.generation_stats(g, feats, t(mask), t(fr), t(fv), skel, 5,
                              16).numpy()
    assert got.shape == want.shape == (40, 4)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(got[:, 1])
    assert np.array_equal(got[fin, 0], np.abs(got[fin, 1]))
    for c in (0, 1):
        np.testing.assert_allclose(got[:, c], want[:, c],
                                   rtol=INTERP_RTOL, atol=INTERP_ATOL)
    vals = np.asarray(jax.jit(J.eval_programs, static_argnums=3)(
        g, bars, mask, skel))
    mine = P.eval_programs(g, t(bars), t(mask), skel).numpy()
    order = same_order(mine, vals, np.isfinite(vals) & fv)
    np.testing.assert_allclose(got[order, 2:], want[order, 2:],
                               rtol=INTERP_RTOL, atol=INTERP_ATOL)
    assert order.sum() > len(g) // 2
    # the stats body on JAX's exposures gives JAX's stats
    body = PF._candidate_stats(t(vals), t(fr), t(fv), 5).numpy()
    assert np.array_equal(np.isnan(body), np.isnan(want))
    np.testing.assert_allclose(body, want, rtol=INTERP_RTOL,
                               atol=INTERP_ATOL)
    # chunked == unchunked, bitwise, with a short last chunk
    whole = PF.generation_stats(g, feats, t(mask), t(fr), t(fv), skel, 5,
                                None).numpy()
    assert np.array_equal(whole, got, equal_nan=True)


def test_device_topk_is_lax_top_k_and_the_host_argsort():
    """The port's device top-k on JAX's fitness column picks JAX's
    indices and values, ties to the lower index and NaN as -1."""
    fit = np.array([0.3, np.nan, 0.5, 0.3, 0.5, 0.0, np.nan, 0.1, 0.5],
                   np.float32)
    for k in (2, 3, 5, 9):
        tv, ti = PF.device_topk(t(fit), k)
        jv, ji = jax.lax.top_k(jax.numpy.nan_to_num(fit, nan=-1.0), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        host = np.argsort(-np.nan_to_num(fit, nan=-1.0), kind="stable")
        np.testing.assert_array_equal(ti.numpy(), host[:k])


def _stub_jax_generation(monkeypatch, bars, mask, fr, fv, calls):
    """Replace the port's generation function by JAX's on the same slab:
    the port's engine then runs on JAX's per-generation stats."""
    def stub(genomes, feats, m, fwd_ret, fwd_valid, *, skeleton,
             group_num, chunk, n_elite):
        calls.append(np.array(genomes))
        s, tv, ti = JF.generation_fitness(genomes, bars, mask, fr, fv,
                                          skeleton=skeleton,
                                          group_num=group_num, chunk=chunk,
                                          n_elite=n_elite)
        return (torch.from_numpy(np.array(s)), torch.from_numpy(
            np.array(tv)), torch.from_numpy(np.array(ti)))
    monkeypatch.setattr(PF, "generation_fitness", stub)


@pytest.mark.parametrize("skeleton,pop,gens,seed",
                         [("default", 14, 3, 42), ("rich", 24, 4, 7)])
def test_the_ga_loop_is_bitwise_jax_given_jax_stats(monkeypatch, skeleton,
                                                    pop, gens, seed):
    bars, mask, fr, fv = _day_data(seed=9)
    calls = []
    _stub_jax_generation(monkeypatch, bars, mask, fr, fv, calls)
    jeng = JDiscoveryEngine(skeleton=skeleton, telemetry=JTelemetry())
    jres = jeng.evolve(jeng.prepare(bars, mask, fr, fv), pop=pop,
                       generations=gens, rng=np.random.default_rng(seed))
    eng = DiscoveryEngine(skeleton=skeleton, telemetry=Telemetry(),
                          device="cpu")
    res = eng.evolve(eng.prepare(bars, mask, fr, fv), pop=pop,
                     generations=gens, rng=np.random.default_rng(seed))
    assert len(calls) == gens + 1  # the build's probe, then each generation
    np.testing.assert_array_equal(res.genome, jres.genome)
    assert res.genome.dtype == jres.genome.dtype
    np.testing.assert_array_equal(res.history, jres.history)
    for f in ("fitness", "mean_ic", "mean_rank_ic", "spread"):
        a, b = getattr(res, f), getattr(jres, f)
        assert (np.isnan(a) and np.isnan(b)) or a == b, f
    assert res.fingerprint == jres.fingerprint
    assert res.skeleton == jres.skeleton
    assert genome_name(res.genome, res.skeleton) == \
        JR.genome_name(jres.genome, jres.skeleton)


def test_evolve_sync_budget_and_zero_builds():
    """Exactly ONE labelled host-blocking sync per generation and
    nothing built during the generation loop; the final generation's
    device top-k is the host's selection."""
    tel = Telemetry()
    bars, mask, fr, fv = _day_data(seed=7)
    eng = DiscoveryEngine(telemetry=tel, device="cpu")
    data = eng.prepare(bars, mask, fr, fv)
    eng.warmup(data, 12)
    reg = tel.registry
    syncs0 = reg.counter_value("research.host_blocking_syncs",
                               point="generation_fetch")
    built0 = reg.counter_value("serve.executables", outcome="miss")
    res = eng.evolve(data, pop=12, generations=4,
                     rng=np.random.default_rng(8))
    assert reg.counter_value("research.host_blocking_syncs",
                             point="generation_fetch") - syncs0 == 4
    assert reg.counter_value("serve.executables", outcome="miss") == built0
    assert res.syncs_per_generation == 1.0
    assert res.compiles_during_loop == 0
    assert res.generations == 4 and len(res.history) == 4
    assert res.n_shards == 1 and res.occupancy == 1.0
    assert reg.counter_value("discover.generations") == 4
    assert eng.progress()["discover.generations_done"] == 4.0
    tv, ti = res.device_topk
    assert ti.shape[0] == 2 and ti.device.type == "cpu"


def test_evolve_deterministic_under_explicit_rng():
    bars, mask, fr, fv = _day_data(seed=9)
    out = []
    for _ in range(2):
        eng = DiscoveryEngine(telemetry=Telemetry(), device="cpu")
        data = eng.prepare(bars, mask, fr, fv)
        out.append(eng.evolve(data, pop=14, generations=3,
                              rng=np.random.default_rng(42)))
    assert np.array_equal(out[0].genome, out[1].genome)
    assert np.array_equal(out[0].history, out[1].history)
    assert out[0].fitness == out[1].fitness
    assert genome_name(out[0].genome) == genome_name(out[1].genome)
    assert out[0].fingerprint == out[1].fingerprint


def test_the_population_sharded_parts_run_on_an_in_process_mesh():
    """Population-sharded discovery is a placement inside one server
    process: ``DiscoveryEngine(mesh=)`` and ``generation_fitness_sharded``
    run on an in-process mesh (tests/test_torch_placements.py holds
    them); a mesh that is not an in-process one is refused."""
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        resident_mesh)
    bars, mask, fr, fv = _day_data(seed=2)
    mesh = resident_mesh(2, devices=["cpu", "cpu"])
    try:
        eng = DiscoveryEngine(mesh=mesh, telemetry=Telemetry())
        assert eng.n_shards == 2
        data = eng.prepare(bars, mask, fr, fv)
        g = P.random_population(np.random.default_rng(0), 6,
                                P.DEFAULT_SKELETON)
        stats, vals, idx = PF.generation_fitness_sharded(
            g, *data.device_args, mesh, n_elite=3)
        assert stats.shape == (6, 4) and vals.shape == idx.shape == (3,)
    finally:
        mesh.close()
    with pytest.raises(TypeError, match="in-process mesh"):
        DiscoveryEngine(mesh=object())


# --------------------------------------------------------------------------
# the server's research mode
# --------------------------------------------------------------------------


def _research_server(tmp_path, **kw):
    tel = Telemetry()
    src = SyntheticSource(n_days=10, n_tickers=24, seed=21)
    scfg = ServeConfig(research_dir=str(tmp_path), hbm_sample_period_s=0)
    srv = FactorServer(src, names=("vol_return1min", "mmt_am"),
                       serve_cfg=scfg, telemetry=tel, research=True,
                       device="cpu", **kw)
    return src, srv, tel


def test_serve_discover_end_to_end(tmp_path):
    """A research server discovers a factor on the request queue,
    registers it, persists its record, and answers ``/v1/query`` for the
    new name with the bits of the persisted genome evaluated on the
    block's decoded bars, with the loop's sync/build counters held."""
    src, server, tel = _research_server(tmp_path)
    try:
        reg = tel.registry
        syncs0 = reg.counter_value("research.host_blocking_syncs",
                                   point="generation_fetch")
        ans = server.discover(0, 8, generations=3, pop=24,
                              seed=7).result(600)
        assert ans["generations"] == 3
        assert ans["syncs_per_generation"] == 1.0
        assert ans["compiles_during_loop"] == 0
        assert ans["n_shards"] == 1
        assert reg.counter_value("research.host_blocking_syncs",
                                 point="generation_fetch") - syncs0 == 3
        name = ans["name"]
        assert name.startswith("disc_") and name in server.names
        fl = server.factor_list()
        assert fl["builtin"] == ["vol_return1min", "mmt_am"]
        assert fl["discovered"] == [name] and fl["research"] is True
        rec = load_record(ans["record_path"])
        assert rec.description == ans["describe"]
        assert rec.fitness == pytest.approx(ans["fitness"])
        q = server.submit(Query("factors", 0, 8,
                                names=(name,))).result(120)
        got = np.asarray(q["exposures"][name], dtype=np.float32)
        bars, mask = src.slab(0, 8)
        w = wire.encode(bars, mask)
        buf, spec = wire.pack_arrays(w.arrays)
        b, m = wire.decode(*wire.unpack(torch.from_numpy(buf), spec))
        ref = P.eval_programs(np.asarray(rec.genome, np.int32)[None], b,
                              m.to(torch.bool), rec.skeleton)[0].numpy()
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(got[~np.isnan(got)],
                                      ref[~np.isnan(ref)])
        ic = server.submit(Query("ic", 0, 8, factor=name)).result(120)
        assert ic["factor"] == name
        assert isinstance(ic["mean_ic"], float)
        assert server.health()["research"] is True
        assert reg.counter_value("discover.registered",
                                 outcome="fresh") >= 1
    finally:
        server.close()


def test_serve_discover_idempotent_and_cache_invalidation(tmp_path):
    """The same seed re-discovers the same genome -> same name, no
    duplicate registration; a block cached before the discovery is
    dropped (the next query rebuilds it over the grown name set)."""
    _src, server, tel = _research_server(tmp_path)
    try:
        before = server.submit(Query("factors", 0, 8,
                                     names=("mmt_am",))).result(120)
        assert "mmt_am" in before["exposures"]
        assert len(server.cache) == 1
        a = server.discover(0, 8, generations=2, pop=16,
                            seed=3).result(600)
        assert len(server.cache) == 0
        b = server.discover(0, 8, generations=2, pop=16,
                            seed=3).result(600)
        assert a["name"] == b["name"]
        assert list(server.names).count(a["name"]) == 1
        after = server.submit(Query("factors", 0, 8,
                                    names=("mmt_am",
                                           a["name"]))).result(120)
        assert set(after["exposures"]) == {"mmt_am", a["name"]}
        assert np.array_equal(
            np.asarray(after["exposures"]["mmt_am"], np.float32),
            np.asarray(before["exposures"]["mmt_am"], np.float32),
            equal_nan=True)
        assert tel.registry.counter_value("discover.registered",
                                          outcome="repeat") >= 1
    finally:
        server.close()


def test_serve_discover_validation(tmp_path):
    src, server, _tel = _research_server(tmp_path)
    try:
        with pytest.raises(ValueError, match="day range"):
            server.discover(0, src.n_days + 1)
        with pytest.raises(ValueError, match="generations"):
            server.discover(0, 8, generations=10_000)
        with pytest.raises(ValueError, match="pop"):
            server.discover(0, 8, pop=10 ** 9)
        with pytest.raises(ValueError, match="horizon"):
            server.discover(0, 2, horizon=2)
        with pytest.raises(ValueError, match="unknown skeleton"):
            server.discover(0, 8, skeleton="nope")
    finally:
        server.close()


def test_serve_discover_failure_fails_the_job_and_bumps_the_breaker(
        tmp_path):
    """A failed job fails its own future and counts a breaker failure;
    the server does not answer without research."""
    _src, server, tel = _research_server(tmp_path)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected")
        server.research_engine.evolve = boom
        with pytest.raises(RuntimeError, match="injected"):
            server.discover(0, 8, generations=2, pop=8).result(120)
        reg = tel.registry
        assert reg.counter_value("serve.failures", stage="discover") == 1
        assert reg.gauge_value("serve.breaker_consecutive_failures") == 1
        assert server.factor_list()["discovered"] == []
    finally:
        server.close()


def test_streamed_server_refuses_intraday_on_discovered(tmp_path):
    """Discovery grows the BLOCK factor set but the streaming carry's
    warm callables were built over the construction-time set, so an
    intraday query for a discovered name refuses loudly (the JAX
    wording), while plain intraday keeps answering."""
    src = SyntheticSource(n_days=10, n_tickers=16, seed=22)
    server = FactorServer(
        src, names=("vol_return1min", "mmt_am"),
        serve_cfg=ServeConfig(research_dir=str(tmp_path),
                              hbm_sample_period_s=0),
        telemetry=Telemetry(), research=True, stream=True, device="cpu")
    try:
        ans = server.discover(0, 8, generations=2, pop=16,
                              seed=4).result(600)
        with pytest.raises(ValueError, match="non-streamable"):
            server.submit(Query("intraday", names=(ans["name"],)))
        intra = server.submit(Query("intraday")).result(120)
        assert set(intra["exposures"]) == {"vol_return1min", "mmt_am"}
        blk = server.submit(Query("factors", 0, 8,
                                  names=(ans["name"],))).result(120)
        assert ans["name"] in blk["exposures"]
    finally:
        server.close()


def test_discover_needs_research_mode():
    src = SyntheticSource(n_days=6, n_tickers=8, seed=1)
    server = FactorServer(src, names=("vol_return1min",),
                          serve_cfg=ServeConfig(hbm_sample_period_s=0),
                          telemetry=Telemetry(), device="cpu")
    try:
        with pytest.raises(ValueError, match="research=True"):
            server.discover(0, 4)
        assert server.factor_list() == {
            "builtin": ["vol_return1min"], "discovered": [], "count": 1,
            "research": False}
        assert server.health()["research"] is False
    finally:
        server.close()


@pytest.mark.parametrize("transport", ["legacy", "edge"])
def test_http_discover_and_factor_routes(tmp_path, transport):
    """POST /v1/discover round-trips the job (the trace-ID header
    echoed), GET /v1/factors lists the result, a malformed body 400s,
    and the discovered factor answers over /v1/query — through the
    legacy door and the evented edge alike."""
    _src, server, _tel = _research_server(tmp_path)
    if transport == "legacy":
        door, _thread = serve_http(server, port=0, timeout=600)
    else:
        door = serve_frontdoor(server, port=0, transport="edge")
    base = f"http://127.0.0.1:{door.server_address[1]}"
    try:
        req = urllib.request.Request(
            f"{base}/v1/discover",
            data=json.dumps({"start": 0, "end": 8, "generations": 2,
                             "pop": 16, "seed": 1}).encode(),
            headers={"X-Trace-Id": "disc-test-1"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            assert resp.headers["X-Trace-Id"] == "disc-test-1"
            ans = json.loads(resp.read())
        assert ans["name"].startswith("disc_")
        assert ans["trace_id"] == "disc-test-1"
        with urllib.request.urlopen(f"{base}/v1/factors",
                                    timeout=60) as resp:
            fl = json.loads(resp.read())
        assert fl == server.factor_list()
        assert ans["name"] in fl["discovered"]
        bad = urllib.request.Request(f"{base}/v1/discover",
                                     data=b'{"start": 0}')
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=60)
        assert ei.value.code == 400
        qreq = urllib.request.Request(
            f"{base}/v1/query",
            data=json.dumps({"kind": "factors", "start": 0, "end": 8,
                             "names": [ans["name"]]}).encode())
        with urllib.request.urlopen(qreq, timeout=120) as resp:
            q = json.loads(resp.read())
        direct = server.client().factors(0, 8, names=(ans["name"],))
        assert np.array_equal(
            np.asarray(q["exposures"][ans["name"]], np.float32),
            np.asarray(direct["exposures"][ans["name"]], np.float32),
            equal_nan=True)
    finally:
        door.shutdown()
        server.close()


def test_research_reload_round_trip(tmp_path):
    """A second research server on the same ``research_dir`` reloads the
    record (``discover.reloaded`` is 1) and answers the discovered name
    with the same bits; a corrupt record is skipped and counted."""
    src, server, _tel = _research_server(tmp_path)
    try:
        ans = server.discover(0, 8, generations=2, pop=16,
                              seed=5).result(600)
        first = server.client().factors(0, 8, names=(ans["name"],))
    finally:
        server.close()
    with open(tmp_path / "disc_0000000000.json", "w") as fh:
        fh.write('{"name": "disc_0000000000", "genome": [1]}')
    tel = Telemetry()
    again = FactorServer(src, names=("vol_return1min", "mmt_am"),
                         serve_cfg=ServeConfig(research_dir=str(tmp_path),
                                               hbm_sample_period_s=0),
                         telemetry=tel, research=True, device="cpu")
    try:
        reg = tel.registry
        assert reg.counter_value("discover.reloaded") == 1
        assert reg.counter_value("discover.reload_failures") == 1
        assert again.factor_list()["discovered"] == [ans["name"]]
        second = again.client().factors(0, 8, names=(ans["name"],))
        a = np.asarray(first["exposures"][ans["name"]], np.float32)
        b = np.asarray(second["exposures"][ans["name"]], np.float32)
        assert np.array_equal(a, b, equal_nan=True)
    finally:
        again.close()
