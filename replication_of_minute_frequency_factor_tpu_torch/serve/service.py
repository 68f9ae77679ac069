"""The resident request loop: async batching, coalescing, load shedding.

The port of the JAX package's ``serve/service.py``. ``FactorServer`` is
the process a notebook (or the HTTP binding) talks to. Requests enqueue
as futures; ONE worker thread drains the queue in micro-batches
(``batch_window_s`` collection window, ``max_batch`` bound), groups each
batch by day-range, and answers every group from ONE device block —
concurrent queries over the same range therefore coalesce into a single
block build (or a single exposure-cache hit), which is the scaling
property the whole serving layer exists for.

Streaming: a server constructed with ``stream=True`` also owns a
:class:`..stream.engine.StreamEngine` over the source's ticker universe
and accepts two more request shapes through the SAME queue —
:meth:`FactorServer.ingest` (minute bars advancing the device-resident
carry) and ``Query(kind="intraday")`` (the carry's partial-day
exposures + readiness plane). Within one micro-batch every ingest
applies in arrival order BEFORE any intraday query (latest-view
semantics), and concurrent intraday queries coalesce onto ONE snapshot
exactly like same-range block queries do.

Failure containment mirrors the batch pipeline's breaker: consecutive
failed dispatches open the circuit and subsequent submits are SHED
(fail fast with :class:`LoadShedError`) until a cooldown lapses; the
first request after the cooldown is the half-open probe. A full queue
sheds too — backpressure must reach the caller as an error, not as an
unbounded latency tail.

The device is explicit: the server runs on ``device`` (default ``cuda``,
which must be present; ``device='cpu'`` runs on the CPU), the worker
thread makes it its current device before its first launch, and
everything the worker enqueues goes to the stream that was current when
the server was built (the stream engine is built on the constructor's
thread and used on the worker's). The work of a dispatch is enqueued,
not waited for; the one host fetch of a query's answer
(:func:`_fetch`, ``.cpu().numpy()``) is where it is waited for, and
where a device error surfaces.

Discovery: a server constructed with ``research=True`` also owns a
:class:`..research.evolve.DiscoveryEngine` on its device and accepts
:meth:`FactorServer.discover` jobs (:class:`Discover`, ``POST
/v1/discover``) through the SAME queue: the worker runs the bounded
search, registers the best genome as a live ``disc_<hash>`` factor
(persisted under ``ServeConfig.research_dir``, reloaded from there at the
next start), grows the served names and clears the exposure cache, so
the next query over any range answers the new name. A failed job fails
its own future and bumps the breaker; it never carries on elsewhere.

Placement: a fleet replica passes ``devices=`` (its group of devices,
from ``fleet.replica.partition_devices``), and the server pins every
launch, cache entry and block to ``devices[0]``, as the JAX package's
server pins its work to the submesh lead. ``health()`` names every
device of the group. Two placements spread one server over all of them,
as in the JAX package: ``ServeConfig.stream_sharded`` places the stream
carry over an in-process tickers mesh of the group
(``parallel.resident_mesh(len(devices), devices)``; only with more than
one device and a universe that divides over them), and
``ServeConfig.discover_sharded`` shards discovery populations over one
(only with more than one device). Otherwise each stays on ``devices[0]``,
silently; the gauges ``stream.carry_sharded`` and ``discover.n_shards``
say which one runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from ..telemetry.opsplane import FlightRecorder, canonical_trace_id
from .engine import ServeEngine
from .executables import ExecutableCache
from .expcache import DeviceExposureCache

_SENTINEL = None  # queue poison pill (requests are _Pending objects)

QUERY_KINDS = ("factors", "ic", "decile", "intraday")

def _fetch(x) -> np.ndarray:
    """The boundary: one device tensor fetched to host numpy (waits for
    the work that makes it)."""
    return x.detach().cpu().numpy()


class LoadShedError(RuntimeError):
    """The server refused the request up front: breaker open after
    sustained dispatch failure, or the bounded queue is full. Callers
    retry later (or against another replica) — the error IS the
    backpressure signal.

    ``retry_after_s`` is the server's backoff hint: the
    remaining breaker cooldown on a breaker shed, the full cooldown on
    a full-queue shed (the queue has no clock; the breaker cooldown is
    the service's one declared backoff constant). The HTTP binding
    renders it as a ``Retry-After`` header on every 503."""

    def __init__(self, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class Query:
    """One question over a day-range ``[start, end)`` (indices into the
    source's day axis — the coalescing key is ``(start, end)``). The
    ``intraday`` kind instead reads the live streaming
    carry's partial-day exposures; its range is ignored (use 0, 0)."""
    kind: str                         # factors | ic | decile | intraday
    start: int = 0
    end: int = 0
    names: Optional[Tuple[str, ...]] = None    # factors: subset (None=all)
    factor: Optional[str] = None               # ic / decile
    horizon: int = 1                           # forward-return horizon
    group_num: int = 5                         # decile buckets
    #: answer encoding: ``json`` answers are host dicts;
    #: ``wire`` ships the block's packed result-wire payload verbatim
    #: (``factors`` kind over the FULL factor set only — the payload IS
    #: the whole [F, D, T] block; see docs/serving.md "The binary
    #: edge"). Not part of the coalescing key: a wire and a json query
    #: over the same range share one dispatch group.
    encoding: str = "json"


@dataclasses.dataclass(frozen=True)
class Discover:
    """One bounded-generations factor-discovery job: an evolutionary
    search over the source's days ``[start, end)`` through the SAME
    request queue as every other request — breaker/shed/trace-ID
    semantics unchanged. The worker runs the search
    (``research/evolve.DiscoveryEngine``, a warm generation callable, one
    labelled host sync per generation), registers the best genome as a
    live factor name (``disc_<hash>``), persists its genome record when
    ``ServeConfig.research_dir`` is set, and resolves the future with the
    name + backtest stats. Generations/population are bounded by
    ``ServeConfig.discover_max_*`` at validation."""
    start: int
    end: int
    generations: int = 4
    pop: int = 128
    seed: int = 0
    horizon: int = 1
    skeleton: str = "default"


@dataclasses.dataclass(frozen=True)
class Ingest:
    """Minute bars for the streaming carry: ``bars
    [B, T, 5]`` f32 / ``present [B, T]`` bool host arrays advance the
    resident day by ``B`` minutes. Within a micro-batch every ingest
    applies IN ARRIVAL ORDER and BEFORE any intraday query —
    latest-view semantics."""
    bars: object
    present: object


@dataclasses.dataclass
class _Pending:
    query: Query
    future: Future
    t_enqueue: float
    #: request-scoped trace ID: generated at admission or
    #: propagated from the caller (``X-Trace-Id`` / ``trace_id=``)
    trace_id: str = ""
    #: admission timestamp on the perf_counter clock — the span
    #: tracer's timebase, for explicit lifecycle span events
    t_pc: float = 0.0


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs (the compute knobs stay on ``config.Config``)."""
    #: micro-batch collection window after the first dequeued request
    batch_window_s: float = 0.002
    #: most requests drained into one micro-batch
    max_batch: int = 64
    #: bounded request queue; a full queue sheds (backpressure)
    queue_limit: int = 1024
    #: device-byte budget of the exposure cache (LRU past it)
    cache_bytes: int = 256 * 1024 * 1024
    #: consecutive failed dispatches before the breaker opens
    breaker_threshold: int = 3
    #: seconds the open breaker sheds before the half-open probe
    breaker_cooldown_s: float = 1.0
    #: flight-recorder ring bound (recent request traces)
    flight_ring: int = 256
    #: where anomaly dumps land (None = ring-only, no files written)
    flight_dir: Optional[str] = None
    #: HBM watermark sampler thread period (0 disables the thread;
    #: dispatch-boundary sampling stays on either way)
    hbm_sample_period_s: float = 0.5
    #: timeline sampler thread period (0 disables the
    #: thread — the SLO plane then evaluates only on explicit
    #: ``timeline.sample()`` calls). Host-side registry reads only;
    #: never a device sync.
    timeline_sample_period_s: float = 0.5
    #: divides every SLO burn window (telemetry/slo.BURN_WINDOWS):
    #: 1.0 = the production SRE 5m/1h + 6h/3d pairs; tests/smokes set
    #: thousands to compress hours into test seconds
    slo_time_scale: float = 1.0
    #: default latency objective: p99 of serve.request_seconds must
    #: stay under this many ms
    slo_latency_ms: float = 250.0
    #: default freshness objective (streaming servers): seconds since
    #: the last applied ingest must stay under this
    slo_staleness_s: float = 120.0
    #: ship factors/intraday answers through the blocked-quantized
    #: result wire: the block's exposures encode on device
    #: (one warm dispatch from the cached RAW f32 block — never from a
    #: decode, so the exposure cache can't double-quantize) and the
    #: answer IS the host-side dequantize of the fetched payload.
    #: Opt-in: quantized slices carry the pinned range-relative error
    #: (data/result_wire.RESULT_BOUNDS), which answer consumers must
    #: accept; widened slices stay bitwise.
    result_wire: bool = False
    #: where discovered-genome records persist as ``disc_<hash>.json``
    #: (None = in-memory registration only); a research server reloads
    #: every record there at startup
    research_dir: Optional[str] = None
    #: upper bounds a ``POST /v1/discover`` request is validated
    #: against — a research server stays a bounded-latency service,
    #: not an unbounded compute endpoint
    discover_max_generations: int = 64
    discover_max_pop: int = 8192
    #: shard discovery populations over this server's devices (an
    #: in-process mesh, ``parallel.resident_mesh``): applied only when the
    #: server has more than one device, otherwise the engine runs on one,
    #: silently (the ``discover.n_shards`` gauge says which ran)
    discover_sharded: bool = False
    #: place the streaming carry over a tickers mesh spanning this
    #: server's devices: applied only when the server has more than one
    #: device and the universe divides over them, otherwise the carry
    #: stays on one, silently (``stream.carry_sharded`` reads 0, else
    #: the shard count); snapshots are bitwise the unsharded engine's
    stream_sharded: bool = False
    #: front-door transport the CLI binds: ``edge`` is the
    #: evented selectors loop (:mod:`.edge` — keep-alive, pipelining,
    #: binary wire answers, per-tenant quotas); ``legacy`` keeps the
    #: stdlib thread-per-connection server for A/B and fallback. Code
    #: that calls :func:`.http.serve_http` / :func:`.edge.serve_edge`
    #: directly picks its own transport regardless of this knob.
    edge: str = "edge"
    #: per-tenant admission quota at the EDGE: sustained
    #: requests/second each ``X-Tenant`` (or API key) may submit,
    #: token-bucket enforced ABOVE pod admission; 0 disables. Refused
    #: requests get 429 + ``Retry-After``, mirroring the shed contract.
    tenant_quota_rps: float = 0.0
    #: token-bucket burst depth (0 -> max(1, tenant_quota_rps))
    tenant_quota_burst: float = 0.0
    #: seconds an edge connection may sit idle (including mid-request —
    #: the slow-loris bound) before the loop reaps it
    edge_idle_timeout_s: float = 30.0
    #: streaming snapshot finalize implementation for this server's
    #: StreamEngine: None adopts ``Config.finalize_impl``
    #: (default 'exact', the bitwise batch-prefix graph); 'fast'
    #: materializes the foldable kernel subset from carried sufficient
    #: statistics in O(F·T) per snapshot (docs/streaming.md "Exactness
    #: classes"). The engine's RESOLVED choice — 'fast' degrades to
    #: 'exact' when the served name set has no foldable kernel — is
    #: reported in ``/healthz`` as ``stream_finalize_impl``.
    stream_finalize_impl: Optional[str] = None


#: the lock contract the runtime lock-assertion twin (telemetry/lockcheck.py)
#: checks: the breaker state and the
#: drain flag are shared between caller threads (submit/ingest/
#: discover) and the worker; ``_state_lock`` guards all of them.
#: ``_dispatch_seq`` (worker-thread-only) and ``names`` (documented
#: atomic-tuple-swap, worker-writes/callers-read) stay out by design.
GLC_CONTRACT = {
    "FactorServer": {
        "lock": "_state_lock",
        "guards": ("_consecutive", "_open_until", "_closed"),
        "init": (),
        "locked": (),
    },
}


class FactorServer:
    """The long-lived factor service over one data source.

    ``start=False`` constructs the server with the worker paused —
    submitted requests queue up and are drained on :meth:`start` (the
    deterministic way to exercise coalescing in tests and smokes).
    """

    def __init__(self, source, names: Optional[Sequence[str]] = None,
                 serve_cfg: Optional[ServeConfig] = None,
                 replicate_quirks: bool = True,
                 rolling_impl: Optional[str] = None,
                 telemetry=None, start: bool = True,
                 stream: bool = False,
                 stream_batches: Sequence[int] = (1,),
                 replica_label: Optional[str] = None,
                 devices: Optional[Sequence] = None,
                 research: bool = False,
                 device=None):
        from ..models.registry import factor_names
        from ..pipeline import resolve_device
        from ..telemetry import get_telemetry
        if devices and device is not None \
                and torch.device(devices[0]) != torch.device(device):
            raise ValueError(f"devices={list(devices)} and device="
                             f"{device!r} name different devices")
        self.source = source
        self.names: Tuple[str, ...] = tuple(names) if names is not None \
            else factor_names()
        self.scfg = serve_cfg or ServeConfig()
        self.telemetry = telemetry if telemetry is not None \
            else get_telemetry()
        #: replica identity: the fleet builds N servers over groups of
        #: devices; ``replica_label`` names this one in health payloads /
        #: flight dumps and ``devices`` is its group, whose first device
        #: it runs on (the others serve the in-server placements). A
        #: standalone server keeps both unset.
        self.replica_label = replica_label or "standalone"
        #: the one device every block, carry and query lives on (default
        #: the card; raises when none is present — never a quiet CPU
        #: fallback)
        self.device = _indexed(resolve_device(devices[0] if devices
                                              else device))
        self.devices: Optional[tuple] = (
            tuple(_indexed(torch.device(d)) for d in devices)
            if devices else None)
        n_devices = len(self.devices or ())
        #: the in-process meshes of the placements (None: one device);
        #: built as the JAX package builds them, closed by close()
        self._stream_mesh = self._research_mesh = None
        if stream and self.scfg.stream_sharded and n_devices > 1 \
                and source.n_tickers % n_devices == 0:
            self._stream_mesh = self._mesh()
        if research and self.scfg.discover_sharded and n_devices > 1:
            self._research_mesh = self._mesh()
        #: the stream every launch of this server goes to: the one
        #: current on the constructor's thread, where the stream engine
        #: is built and warmed; the worker enters it too
        self._cuda_stream = (torch.cuda.current_stream(self.device)
                             if self.device.type == "cuda" else None)
        #: market session: adopted from the source (a source built for
        #: us_390 serves us_390 — the session is a property of the DATA,
        #: not a request knob); sources without the attribute serve the
        #: canonical cn_ashare_240 day
        from ..markets import get_session
        self.session = get_session(getattr(source, "session", None))
        self.executables = ExecutableCache(telemetry=self.telemetry)
        self.engine = ServeEngine(self.names,
                                  replicate_quirks=replicate_quirks,
                                  rolling_impl=rolling_impl,
                                  telemetry=self.telemetry,
                                  executables=self.executables,
                                  session=self.session,
                                  device=self.device)
        self.cache = DeviceExposureCache(self.scfg.cache_bytes,
                                         telemetry=self.telemetry)
        #: the live intraday engine over the source's ticker universe,
        #: sharing THE executable cache (one build-count ground truth).
        #: Warmed at construction for the declared ingest micro-batch
        #: shapes, so steady-state ingest/intraday traffic builds
        #: nothing. ``stream.carry_sharded`` reads the carry's shard count
        #: (0: on ``devices[0]`` alone).
        self.stream_engine = None
        if stream:
            from ..stream.engine import StreamEngine
            mesh = self._stream_mesh
            self.telemetry.gauge("stream.carry_sharded",
                                 0 if mesh is None else mesh.size)
            self.stream_engine = StreamEngine(
                source.n_tickers, names=self.names,
                replicate_quirks=replicate_quirks,
                rolling_impl=rolling_impl, telemetry=self.telemetry,
                executables=self.executables, session=self.session,
                finalize_impl=self.scfg.stream_finalize_impl,
                mesh=mesh, device=None if mesh else self.device)
            self.stream_engine.warmup(micro_batches=stream_batches)
        #: the factor-discovery engine on this server's device, sharing
        #: THE executable cache. Built-in names are pinned here so
        #: ``factor_list`` can split built-in from discovered after
        #: registrations grow ``self.names``.
        self.research_engine = None
        if research:
            from ..research.evolve import DiscoveryEngine
            mesh = self._research_mesh
            self.research_engine = DiscoveryEngine(
                telemetry=self.telemetry, executables=self.executables,
                mesh=mesh, device=None if mesh else self.device)
            self.telemetry.gauge("discover.n_shards",
                                 self.research_engine.n_shards)
        self._builtin_names: Tuple[str, ...] = self.names
        #: a research server's discoveries survive the process: restart
        #: reloads every persisted ``disc_<hash>.json`` under
        #: ``research_dir`` into the live registry and this server's
        #: factor set, so a previously discovered name is queryable the
        #: moment the server is up
        if research and self.scfg.research_dir:
            self._reload_discoveries()
        self._q: "queue.Queue" = queue.Queue(maxsize=self.scfg.queue_limit)
        self._state_lock = threading.Lock()
        self._consecutive = 0
        self._open_until: Optional[float] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        #: ops plane: flight recorder for anomaly capture + the
        #: telemetry-bound memory watermark sampler, bound to this
        #: server's device
        self.flight = FlightRecorder(telemetry=self.telemetry,
                                     ring=self.scfg.flight_ring,
                                     dump_dir=self.scfg.flight_dir)
        self.telemetry.hbm.configure(device=self.device)
        #: factor-health plane: drift bursts dump through THIS server's
        #: flight recorder into the same flight_dir, so a
        #: factor_drift_burst capture sits next to the breaker-trip ones
        #: and carries the recent request ring
        self.telemetry.factorplane.configure(
            dump_dir=self.scfg.flight_dir, flight=self.flight)
        self._t_start = time.monotonic()
        self._dispatch_seq = 0  # worker-thread-only; no lock needed
        if self.scfg.hbm_sample_period_s > 0:
            self.telemetry.hbm.start(self.scfg.hbm_sample_period_s)
        #: SLO plane: the continuous timeline sampler + declarative
        #: burn-rate objectives. The sampler reads only host-side state
        #: (registry snapshots, the stream engine's staleness mirror, the
        #: discovery engine's progress mirror); an alert transition force-dumps THIS server's flight recorder
        #: under the ``slo_burn`` trigger.
        self.timeline = self.telemetry.timeline
        self.sloplane = self.telemetry.sloplane
        if self.stream_engine is not None:
            eng = self.stream_engine

            def _stream_freshness(eng=eng):
                s = eng.staleness_s()
                if s is None:
                    return {}
                return {"stream.staleness_s": round(s, 6)}

            self.timeline.add_source(_stream_freshness)
        if self.research_engine is not None:
            self.timeline.add_source(self.research_engine.progress)
        from ..telemetry.slo import serve_objectives
        self.sloplane.configure(
            serve_objectives(latency_ms=self.scfg.slo_latency_ms,
                             staleness_s=self.scfg.slo_staleness_s,
                             streaming=self.stream_engine is not None),
            flight=self.flight, timeline=self.timeline,
            time_scale=self.scfg.slo_time_scale)
        if self.scfg.timeline_sample_period_s > 0:
            self.timeline.start(self.scfg.timeline_sample_period_s)
        from ..telemetry.lockcheck import maybe_install
        maybe_install(self)
        if start:
            self.start()

    def _device_ctx(self):
        """Make this server's device and stream current on the calling
        thread (the worker enters it before its first launch); a no-op
        on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        torch.cuda.set_device(self.device)
        return torch.cuda.stream(self._cuda_stream)

    def _mesh(self):
        """An in-process tickers mesh over this server's devices."""
        from ..parallel.mesh import resident_mesh
        return resident_mesh(len(self.devices), devices=self.devices)

    # --- lifecycle ------------------------------------------------------
    def start(self) -> "FactorServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True,
                                            name="factor-serve-worker")
            self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Drain-and-stop: queued requests are still answered; new
        submits are refused."""
        with self._state_lock:
            # the flag is read by every
            # submit/ingest/discover caller; the unlocked write
            # worked only by CPython-coincidence
            self._closed = True
        if self._thread is not None and self._thread.is_alive():
            self._q.put(_SENTINEL)
            self._thread.join(timeout)
        for mesh in (self._stream_mesh, self._research_mesh):
            if mesh is not None:
                mesh.close()
        if self.scfg.hbm_sample_period_s > 0:
            self.telemetry.hbm.stop()
        if self.scfg.timeline_sample_period_s > 0:
            self.timeline.stop()

    def debug_dump(self, out_dir: Optional[str] = None) -> Optional[str]:
        """On-demand flight-recorder capture (``POST /v1/debug/dump``):
        dump the ring + last-dispatch metadata + counter deltas now.
        Returns the dump path (None when no directory is configured)."""
        return self.flight.dump("manual", out_dir=out_dir, force=True)

    def __enter__(self) -> "FactorServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- client side ----------------------------------------------------
    def client(self, timeout: Optional[float] = 60.0) -> "ServeClient":
        return ServeClient(self, timeout=timeout)

    def _validate(self, q: Query) -> None:
        if q.kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {q.kind!r} "
                             f"(one of {QUERY_KINDS})")
        if q.encoding not in ("json", "wire"):
            raise ValueError(f"unknown answer encoding {q.encoding!r} "
                             f"(json or wire)")
        if q.encoding == "wire" and (q.kind != "factors" or q.names):
            # the wire payload IS the whole [F, D, T] block — a subset
            # or a scalar-shaped answer has no packed representation
            raise ValueError(
                "wire encoding answers kind='factors' over the full "
                "factor set only (names=None); ask for json otherwise")
        if q.kind == "intraday":
            if self.stream_engine is None:
                raise ValueError("intraday queries need a server "
                                 "constructed with stream=True")
            # validate against the STREAM engine's factor set: a
            # discovered factor grows self.names for block queries, but
            # the streaming carry's warm callables were built over the
            # construction-time set — genome factors have no incremental
            # finalize, so intraday must refuse them loudly
            unknown = [n for n in (q.names or ())
                       if n not in self.stream_engine.names]
            if unknown:
                raise ValueError(
                    f"unknown factor(s) {unknown} for intraday — "
                    f"non-streamable (a discovered factor) or "
                    f"unregistered; the stream engine holds "
                    f"{len(self.stream_engine.names)}")
            return
        n_days = self.source.n_days
        if not (0 <= q.start < q.end <= n_days):
            raise ValueError(f"day range [{q.start}, {q.end}) outside "
                             f"the source's {n_days} days")
        if q.kind == "factors":
            unknown = [n for n in (q.names or ()) if n not in self.names]
            if unknown:
                raise ValueError(f"unknown factor(s) {unknown}; server "
                                 f"holds {len(self.names)}")
        else:
            if q.factor not in self.names:
                raise ValueError(f"unknown factor {q.factor!r}")
            if not (1 <= q.horizon < q.end - q.start):
                raise ValueError(
                    f"horizon {q.horizon} needs a range longer than "
                    f"itself (got {q.end - q.start} days)")
            if q.kind == "decile" and q.group_num < 2:
                raise ValueError("group_num must be >= 2")

    def submit(self, q: Query,
               trace_id: Optional[str] = None) -> Future:
        """Enqueue; returns a Future resolving to the answer dict.
        Raises :class:`LoadShedError` immediately when shedding (open
        breaker / full queue) and ``ValueError`` on a malformed query —
        validation cost stays on the caller's thread. ``trace_id``
        propagates a caller-assigned request trace ID; None
        generates one at admission. The answer dict carries it back."""
        if self._closed:
            raise RuntimeError("server is closed")
        self._validate(q)
        return self._enqueue(q, q.kind, trace_id)

    def ingest(self, bars, present,
               trace_id: Optional[str] = None) -> Future:
        """Enqueue minute bars for the streaming carry: ``bars
        [B, T, 5]`` f32 / ``present [B, T]`` bool advance the resident
        day by ``B`` minutes through the request queue (so ordering
        against intraday queries is the worker's, not the caller's).
        Returns a Future resolving to ``{"minute", "bars"}``; sheds and
        validates exactly like :meth:`submit`."""
        if self._closed:
            raise RuntimeError("server is closed")
        if self.stream_engine is None:
            raise ValueError("ingest needs a server constructed with "
                             "stream=True")
        bars = np.ascontiguousarray(bars, np.float32)
        present = np.ascontiguousarray(present, bool)
        if bars.ndim != 3 or bars.shape[-1] != 5 \
                or present.shape != bars.shape[:2]:
            raise ValueError(
                f"ingest wants bars [B, T, 5] with present [B, T]; got "
                f"{bars.shape} / {present.shape}")
        if present.shape[1] != self.stream_engine.n_tickers:
            raise ValueError(
                f"got {present.shape[1]} tickers; the stream engine "
                f"holds {self.stream_engine.n_tickers}")
        return self._enqueue(Ingest(bars, present), "ingest", trace_id)

    def discover(self, start: int, end: int, generations: int = 4,
                 pop: int = 128, seed: int = 0, horizon: int = 1,
                 skeleton: str = "default",
                 trace_id: Optional[str] = None) -> Future:
        """Enqueue a bounded-generations discovery job over days
        ``[start, end)``. Returns a Future resolving to the discovery
        answer (name, backtest stats, record path); sheds and validates
        exactly like :meth:`submit` — the breaker and the bounded queue
        apply to research traffic unchanged."""
        from ..research.evolve import resolve_skeleton
        if self._closed:
            raise RuntimeError("server is closed")
        if self.research_engine is None:
            raise ValueError("discover needs a server constructed "
                             "with research=True")
        n_days = self.source.n_days
        if not (0 <= start < end <= n_days):
            raise ValueError(f"day range [{start}, {end}) outside the "
                             f"source's {n_days} days")
        if not (1 <= horizon < end - start):
            raise ValueError(
                f"horizon {horizon} needs a range longer than itself "
                f"(got {end - start} days)")
        if not (1 <= generations
                <= self.scfg.discover_max_generations):
            raise ValueError(
                f"generations must be in [1, "
                f"{self.scfg.discover_max_generations}]")
        if not (2 <= pop <= self.scfg.discover_max_pop):
            raise ValueError(
                f"pop must be in [2, {self.scfg.discover_max_pop}]")
        resolve_skeleton(skeleton)  # raises on an unknown name
        return self._enqueue(
            Discover(int(start), int(end), int(generations), int(pop),
                     int(seed), int(horizon), skeleton),
            "discover", trace_id)

    def factor_list(self) -> dict:
        """``GET /v1/factors``: the server's live factor universe — the
        built-in names it was constructed over plus every factor
        discovered since, each immediately queryable by name through
        the normal ``/v1/query`` leg."""
        names = self.names  # one atomic read (registration swaps it)
        builtin = [n for n in names if n in self._builtin_names]
        discovered = [n for n in names if n not in self._builtin_names]
        return {"builtin": builtin, "discovered": discovered,
                "count": len(names),
                "research": self.research_engine is not None}

    def _enqueue(self, item, kind: str,
                 trace_id: Optional[str] = None) -> Future:
        """Shed gate + enqueue shared by queries and ingests. Every
        admitted request gets its trace ID HERE (propagated when the
        caller supplied a well-formed one, generated otherwise) — the
        single admission point, so no request can cross the queue
        anonymously."""
        tel = self.telemetry
        now = time.monotonic()
        with self._state_lock:
            if self._open_until is not None:
                if now < self._open_until:
                    tel.counter("serve.load_shed", reason="breaker")
                    self.flight.note_shed("breaker")
                    raise LoadShedError(
                        "breaker open after "
                        f"{self._consecutive} consecutive dispatch "
                        "failures; retry after the cooldown",
                        retry_after_s=self._open_until - now)
                # half-open: this request is the probe; keep the gate up
                # for everyone else until it succeeds
                self._open_until = now + self.scfg.breaker_cooldown_s
        pending = _Pending(item, Future(), now,
                           trace_id=canonical_trace_id(trace_id),
                           t_pc=time.perf_counter())
        try:
            self._q.put_nowait(pending)
        except queue.Full:
            tel.counter("serve.load_shed", reason="queue_full")
            self.flight.note_shed("queue_full")
            raise LoadShedError(
                f"request queue full ({self.scfg.queue_limit})",
                retry_after_s=self.scfg.breaker_cooldown_s) from None
        tel.counter("serve.requests", kind=kind)
        self._note_depth()
        return pending.future

    def _note_depth(self) -> None:
        depth = self._q.qsize()
        self.telemetry.gauge("serve.queue_depth", depth)
        self.telemetry.observe("serve.queue_depth", depth)

    # --- breaker --------------------------------------------------------
    def _breaker_failure(self) -> None:
        tel = self.telemetry
        tripped = False
        with self._state_lock:
            self._consecutive += 1
            tel.gauge("serve.breaker_consecutive_failures",
                      self._consecutive)
            if self._consecutive >= self.scfg.breaker_threshold:
                self._open_until = (time.monotonic()
                                    + self.scfg.breaker_cooldown_s)
                tel.counter("serve.breaker_trips")
                tripped = True
        if tripped:
            # flight-recorder anomaly capture: the ring holds
            # the failed requests' traces at this moment — dump outside
            # the state lock, forced (trips are rare by construction)
            self.flight.dump("breaker_trip", force=True)

    def _breaker_ok(self) -> None:
        with self._state_lock:
            self._consecutive = 0
            self._open_until = None
        self.telemetry.gauge("serve.breaker_consecutive_failures", 0)

    def breaker_state(self) -> str:
        """``closed`` / ``open`` / ``half_open`` — the breaker as a
        label (health payloads, the fleet routing policy). ``open``
        means submits shed right now; ``half_open`` means the cooldown
        lapsed and the next submit is the probe."""
        with self._state_lock:
            if self._open_until is None:
                return "closed"
            return ("open" if time.monotonic() < self._open_until
                    else "half_open")

    # --- health (one shape for standalone AND fleet) ----------
    def health(self) -> dict:
        """The ``/healthz`` payload: liveness + breaker + queue depth +
        flight/HBM markers, PLUS the ``replica`` identity block (label,
        device set, breaker state) — the standalone server and every
        fleet replica report the same shape, so the pod rollup is a
        dict of these with nothing translated."""
        with self._state_lock:
            open_until = self._open_until
            consecutive = self._consecutive
        hbm = self.telemetry.hbm.sample("healthz")
        device_names = [_device_name(d)
                        for d in (self.devices or (self.device,))]
        payload = {
            "ok": True, "factors": len(self.names),
            "days": self.source.n_days,
            "session": self.session.name,
            "breaker_open": open_until is not None,
            "breaker_consecutive_failures": consecutive,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "queue_depth": self._q.qsize(),
            "flight": {"requests": len(self.flight),
                       "dumps": self.flight.dump_count,
                       # non-forced dumps the 1/s
                       # rate limit dropped — no longer silent
                       "suppressed": self.flight.suppressed_count},
            "hbm_available": bool(hbm.get("available")),
            "research": self.research_engine is not None,
            "replica": {"label": self.replica_label,
                        "devices": device_names,
                        "breaker": self.breaker_state()},
            # factor-health block: the data-quality view —
            # worst-coverage factor, widen rate, drift bursts — shared
            # VERBATIM by the standalone endpoint and every fleet
            # replica (the pod rollup reads these, nothing translated),
            # like the replica identity block above
            "factor_health": self.telemetry.factorplane.summary(),
        }
        if self.stream_engine is not None:
            payload["stream_minute"] = self.stream_engine.minutes
            # wall-clock freshness next to the
            # cursor — shared VERBATIM standalone/replica (the fleet
            # pod rollup reads this key), None until the first ingest
            s = self.stream_engine.staleness_s()
            payload["stream_staleness_s"] = (None if s is None
                                             else round(s, 3))
            # the RESOLVED finalize impl — 'fast' only when
            # requested AND the served set has a foldable kernel, so
            # an operator reads what actually runs, not what was asked
            payload["stream_finalize_impl"] = \
                self.stream_engine.finalize_impl_resolved
        return payload

    # --- request-lifecycle recording --------------------------
    def _complete(self, p: _Pending, op: str, status: str,
                  dispatch_id: int, group_size: int, block_s: float,
                  answer_s: float, t_dispatch: float,
                  error: Optional[BaseException] = None) -> None:
        """Close out one request's trace: emit the schema-v2 lifecycle
        record (admission → queue-wait → dispatch → answer), fan the
        coalesced dispatch's device time back to this member's trace ID
        as explicit span events, and feed the flight-recorder ring."""
        tel = self.telemetry
        now = time.monotonic()
        queue_wait = max(0.0, t_dispatch - p.t_enqueue)
        total = now - p.t_enqueue
        share = block_s / group_size if group_size else block_s
        data = {
            "queue_wait_s": round(queue_wait, 6),
            "dispatch_id": dispatch_id,
            "group_size": group_size,
            "coalesced": group_size > 1,
            "block_s": round(block_s, 6),
            "device_share_s": round(share, 6),
            "answer_s": round(answer_s, 6),
            "total_s": round(total, 6),
        }
        if error is not None:
            data["error"] = f"{type(error).__name__}: {error}"
        trace = {"trace_id": p.trace_id, "op": op, "status": status,
                 "data": data}
        tel.request(trace)
        self.flight.record_request(trace)
        tr = tel.tracer
        tr.add_span("serve.queue_wait", p.t_pc, queue_wait,
                    trace_id=p.trace_id)
        tr.add_span("serve.dispatch_share", p.t_pc + queue_wait, share,
                    trace_id=p.trace_id)
        tr.add_span("serve.request", p.t_pc, total,
                    trace_id=p.trace_id, kind=op)

    def _next_dispatch(self) -> int:
        self._dispatch_seq += 1
        return self._dispatch_seq

    # --- worker ---------------------------------------------------------
    def _worker(self) -> None:
        try:
            # the current device and stream are per thread: make the
            # server's current on the worker (launches happen here, not
            # on the submitting threads)
            with self._device_ctx():
                self._worker_loop()
        except BaseException:
            # an exception ESCAPING the loop (per-request failures are
            # contained above) would kill the worker silently — capture
            # the last moments first
            self.flight.dump("worker_exception", force=True)
            raise

    def _worker_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            batch = [item]
            deadline = time.monotonic() + self.scfg.batch_window_s
            stop_after = False
            while len(batch) < self.scfg.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop_after = True
                    break
                batch.append(nxt)
            self._note_depth()
            self.telemetry.observe("serve.batch_size", len(batch))
            # ingests first, in arrival order (latest-view semantics:
            # every intraday answer in this micro-batch sees every bar
            # that arrived before the batch was drained)
            ingests = [p for p in batch if isinstance(p.query, Ingest)]
            # discovery jobs run after ingests and BEFORE query groups: a
            # factor registered by this micro-batch's job is queryable by
            # the NEXT request, and a query group dispatched after it
            # already sees the grown name set
            discovers = [p for p in batch
                         if isinstance(p.query, Discover)]
            queries = [p for p in batch
                       if not isinstance(p.query, (Ingest, Discover))]
            groups: Dict[Tuple[int, int], list] = {}
            for p in queries:
                key = ("intraday" if p.query.kind == "intraday"
                       else (p.query.start, p.query.end))
                groups.setdefault(key, []).append(p)
            self.telemetry.gauge("serve.inflight", len(batch))
            for p in ingests:
                self._apply_ingest(p)
            for p in discovers:
                self._apply_discover(p)
            for key, group in groups.items():
                if key == "intraday":
                    self._dispatch_intraday(group)
                else:
                    self._dispatch_group(key, group)
            self.telemetry.gauge("serve.inflight", 0)
            if stop_after:
                return

    def _apply_ingest(self, p: _Pending) -> None:
        """Advance the streaming carry by one Ingest (one scan
        dispatch). A failed ingest fails only its own future but bumps
        the breaker — a stuck feed must shed, not queue unboundedly."""
        tel = self.telemetry
        did = self._next_dispatch()
        t_dispatch = time.monotonic()
        with tel.tracer("serve.ingest", trace_id=p.trace_id):
            try:
                t0 = time.perf_counter()
                self.stream_engine.ingest_minutes(p.query.bars,
                                                  p.query.present)
                ingest_s = time.perf_counter() - t0
                tel.observe("serve.stage_seconds", ingest_s,
                            stage="ingest")
            except Exception as e:  # noqa: BLE001 — per-request + breaker
                tel.counter("serve.failures", stage="ingest")
                self._complete(p, "ingest", "error", did, 1,
                               time.perf_counter() - t0, 0.0,
                               t_dispatch, error=e)
                self._breaker_failure()
                p.future.set_exception(e)
                return
            self._breaker_ok()
            p.future.set_result({
                "trace_id": p.trace_id,
                "minute": self.stream_engine.minutes,
                "bars": int(p.query.present.sum())})
            tel.observe("serve.request_seconds",
                        time.monotonic() - p.t_enqueue, kind="ingest")
            self._complete(p, "ingest", "ok", did, 1, ingest_s, 0.0,
                           t_dispatch)
        self.flight.note_dispatch({"dispatch_id": did, "op": "ingest",
                                   "minute": self.stream_engine.minutes})
        tel.hbm.sample("serve.ingest")

    def _reload_discoveries(self) -> int:
        """Reload persisted ``disc_*.json`` records from ``research_dir``
        into ``research/registry`` and this server's factor universe
        (construction-time; no worker is running yet, so growing
        ``self.names`` here is single-threaded). Corrupted records are
        skipped loudly — one bad file must not take the server down.
        Returns the number of reloaded records."""
        import glob as _glob
        import os as _os

        from ..research import registry as research_registry
        from ..utils.logging import get_logger
        n = 0
        for path in sorted(_glob.glob(_os.path.join(
                self.scfg.research_dir, "disc_*.json"))):
            try:
                rec = research_registry.load_record(path)
            except (OSError, ValueError, KeyError) as e:
                get_logger(__name__).warning(
                    "skipping unloadable discovery record %s: %s",
                    path, e)
                self.telemetry.counter("discover.reload_failures")
                continue
            research_registry.register_genome(
                rec.genome, rec.skeleton, fitness=rec.fitness,
                mean_ic=rec.mean_ic, mean_rank_ic=rec.mean_rank_ic,
                spread=rec.spread, generations=rec.generations,
                pop=rec.pop, data_fingerprint=rec.data_fingerprint,
                telemetry=self.telemetry)
            if rec.name not in self.names:
                self.names = self.names + (rec.name,)
                self.engine.names = self.names
            self.telemetry.counter("discover.reloaded")
            n += 1
        return n

    def _apply_discover(self, p: _Pending) -> None:
        """Run one bounded-generations discovery job: prepare + warm the
        generation callable (builds land HERE, before the generation
        loop — the job's measured ``compiles_during_loop`` must be 0),
        evolve, register the best genome into the live factor universe,
        and clear the exposure cache (cached blocks predate the new name
        and hold the wrong ``[F]`` extent). A failed job fails only its
        own future but bumps the breaker, like ingest."""
        from ..research import fitness as research_fitness
        from ..research import registry as research_registry
        from ..research.evolve import resolve_skeleton
        tel = self.telemetry
        did = self._next_dispatch()
        t_dispatch = time.monotonic()
        d: Discover = p.query
        with tel.tracer("serve.discover", trace_id=p.trace_id):
            t0 = time.perf_counter()
            try:
                bars, mask = self.source.slab(d.start, d.end)
                fwd_ret, fwd_valid = \
                    research_fitness.host_forward_returns(
                        bars, mask, d.horizon)
                eng = self.research_engine
                eng.skeleton = resolve_skeleton(d.skeleton)
                data = eng.prepare(bars, mask, fwd_ret, fwd_valid,
                                   horizon=d.horizon)
                eng.warmup(data, d.pop)
                result = eng.evolve(
                    data, pop=d.pop, generations=d.generations,
                    rng=np.random.default_rng(d.seed))
                rec = research_registry.register_genome(
                    result.genome, result.skeleton,
                    fitness=result.fitness, mean_ic=result.mean_ic,
                    mean_rank_ic=result.mean_rank_ic,
                    spread=result.spread,
                    generations=result.generations, pop=result.pop,
                    data_fingerprint=result.fingerprint,
                    save_dir=self.scfg.research_dir, telemetry=tel)
                if rec.name not in self.names:
                    # atomic tuple swap: submit-side validation reads
                    # self.names without the state lock. The engine's
                    # copy grows with it (block builds run over
                    # engine.names; both writes happen on the worker
                    # thread, the only thread that dispatches), and
                    # cached blocks are dropped — they predate the new
                    # name and hold the wrong [F] extent.
                    self.names = self.names + (rec.name,)
                    self.engine.names = self.names
                    self.cache.clear()
                job_s = time.perf_counter() - t0
                tel.observe("serve.stage_seconds", job_s,
                            stage="discover")
            except Exception as e:  # noqa: BLE001 — per-job + breaker
                tel.counter("serve.failures", stage="discover")
                self._complete(p, "discover", "error", did, 1,
                               time.perf_counter() - t0, 0.0,
                               t_dispatch, error=e)
                self._breaker_failure()
                p.future.set_exception(e)
                return
            record_path = None
            if self.scfg.research_dir:
                import os as _os
                record_path = _os.path.join(self.scfg.research_dir,
                                            f"{rec.name}.json")
            self._breaker_ok()
            p.future.set_result({
                "trace_id": p.trace_id,
                "name": rec.name,
                "describe": rec.description,
                "fitness": result.fitness,
                "mean_ic": result.mean_ic,
                "mean_rank_ic": result.mean_rank_ic,
                "spread": result.spread,
                "generations": result.generations,
                "pop": result.pop,
                "n_shards": result.n_shards,
                "syncs_per_generation": result.syncs_per_generation,
                "compiles_during_loop": result.compiles_during_loop,
                "history": [round(h, 6) for h in result.history],
                "record_path": record_path,
            })
            tel.observe("serve.request_seconds",
                        time.monotonic() - p.t_enqueue, kind="discover")
            self._complete(p, "discover", "ok", did, 1, job_s, 0.0,
                           t_dispatch)
        self.flight.note_dispatch({"dispatch_id": did, "op": "discover",
                                   "name": rec.name,
                                   "generations": result.generations})
        tel.hbm.sample("serve.discover")

    def _dispatch_intraday(self, group: list) -> None:
        """ONE warm snapshot dispatch (+ one host fetch) answers every
        intraday request in ``group`` — the same coalescing contract as
        the block path, over the live carry instead of a cached
        block."""
        tel = self.telemetry
        did = self._next_dispatch()
        t_dispatch = time.monotonic()
        with tel.tracer("serve.dispatch"):
            block_s = 0.0
            try:
                t0 = time.perf_counter()
                if self.scfg.result_wire:
                    # one fused finalize+encode(+stats) dispatch; the
                    # answer is the host dequantize of the fetched
                    # payload, and the per-factor quality sketch rode
                    # the same fetch
                    from ..data import result_wire as _rw
                    eng = self.stream_engine
                    payload, ready, st = eng.snapshot_wire_stats()
                    pay = _fetch(payload)   # the boundary fetch
                    rdy = _fetch(ready)
                    exp, _v = _rw.decode_block(
                        pay, len(eng.names), 1, eng.n_tickers,
                        eng.result_spec.spill_rows,
                        telemetry=self.telemetry,
                        names=eng.names)
                    exp = exp[:, 0, :]
                    self.telemetry.counter("serve.result_wire_answers")
                    self.telemetry.counter("serve.result_wire_bytes",
                                           _v["payload_bytes"])
                else:
                    exposures, ready, st = \
                        self.stream_engine.snapshot_stats()
                    exp = _fetch(exposures)   # the boundary fetch
                    rdy = _fetch(ready)
                block_s = time.perf_counter() - t0
                # factor-health sample: fused stats +
                # per-factor readiness fraction + the carry's minute —
                # the stream's data-level lag signal
                tel.factorplane.observe_stream(
                    self.stream_engine.names, st,
                    ready_frac=rdy.mean(axis=1),
                    minute=self.stream_engine.minutes,
                    boundary="serve.intraday")
                tel.observe("serve.stage_seconds", block_s,
                            stage="block")
            except Exception as e:  # noqa: BLE001 — fail the group, shed
                block_s = time.perf_counter() - t0
                # traces first (a breaker trip dumps them), then the
                # breaker, then the callers
                for p in group:
                    self._complete(p, "intraday", "error", did,
                                   len(group), block_s, 0.0, t_dispatch,
                                   error=e)
                tel.counter("serve.failures", stage="block")
                self._breaker_failure()
                for p in group:
                    p.future.set_exception(e)
                return
            if len(group) > 1:
                tel.counter("serve.coalesced_dispatches")
                tel.counter("serve.coalesced_requests", len(group))
            minute = self.stream_engine.minutes
            ok = True
            answered, failed = [], []
            for p in group:
                t0 = time.perf_counter()
                try:
                    result = self._answer_intraday(exp, rdy, minute,
                                                   p.query)
                except Exception as e:  # noqa: BLE001 — per-request
                    tel.counter("serve.failures", stage="answer")
                    self._complete(p, "intraday", "error", did,
                                   len(group), block_s,
                                   time.perf_counter() - t0,
                                   t_dispatch, error=e)
                    failed.append((p, e))
                    ok = False
                    continue
                answered.append((p, result, time.perf_counter() - t0))
            # the breaker reads this dispatch's outcome before any member
            # sees its answer, so a caller that got one sees the breaker
            # it left behind
            if ok:
                self._breaker_ok()
            else:
                self._breaker_failure()
            for p, e in failed:
                p.future.set_exception(e)
            self._deliver(answered, did, len(group), block_s, t_dispatch)
        self.flight.note_dispatch({"dispatch_id": did, "op": "intraday",
                                   "group_size": len(group),
                                   "block_s": round(block_s, 6)})
        tel.hbm.sample("serve.dispatch")

    def _deliver(self, answered: list, did: int, group_size: int,
                 block_s: float, t_dispatch: float) -> None:
        """Resolve each answered member's future and record it."""
        tel = self.telemetry
        for p, result, answer_s in answered:
            kind = p.query.kind
            result["trace_id"] = p.trace_id
            p.future.set_result(result)
            now = time.monotonic()
            tel.observe("serve.stage_seconds", answer_s, stage="answer")
            tel.observe("serve.stage_seconds",
                        t_dispatch - p.t_enqueue, stage="queue_wait")
            tel.observe("serve.request_seconds", now - p.t_enqueue,
                        kind=kind)
            self._complete(p, kind, "ok", did, group_size, block_s,
                           answer_s, t_dispatch)

    def _answer_intraday(self, exp: np.ndarray, rdy: np.ndarray,
                         minute: int, q: Query) -> dict:
        # index by the STREAM engine's names: the snapshot's [F, T]
        # rows follow its construction-time set, which a later
        # discovery registration never grows (see _validate)
        stream_names = self.stream_engine.names
        names = q.names or stream_names
        idx = [stream_names.index(n) for n in names]
        return {
            "minute": minute,
            "codes": list(self.source.codes),
            "exposures": {n: exp[i].tolist()
                          for n, i in zip(names, idx)},
            # readiness is the SOUND gate (docs/streaming.md): False
            # means the kernel's defining group is still empty at this
            # minute; True with NaN means degenerate data, not absence
            "ready": {n: rdy[i].tolist() for n, i in zip(names, idx)},
        }

    def _dispatch_group(self, key: Tuple[int, int], group: list) -> None:
        """One device block answers every request in ``group`` — the
        coalescing contract. A block failure fails the whole group and
        bumps the breaker once."""
        tel = self.telemetry
        did = self._next_dispatch()
        t_dispatch = time.monotonic()
        with tel.tracer("serve.dispatch"):
            block_s = 0.0
            cached = False
            try:
                t0 = time.perf_counter()
                block = self.cache.get(key)
                cached = block is not None
                if block is None:
                    bars, mask = self.source.slab(*key)
                    block = self.engine.build_block(bars, mask)
                    self.cache.put(key, block)
                    tel.counter("serve.dispatches")
                block_s = time.perf_counter() - t0
                tel.observe("serve.stage_seconds", block_s,
                            stage="block")
            except Exception as e:  # noqa: BLE001 — fail the group, shed
                block_s = time.perf_counter() - t0
                # traces first (a breaker trip dumps them), then the
                # breaker, then the callers
                for p in group:
                    self._complete(p, p.query.kind, "error", did,
                                   len(group), block_s, 0.0, t_dispatch,
                                   error=e)
                tel.counter("serve.failures", stage="block")
                self._breaker_failure()
                for p in group:
                    p.future.set_exception(e)
                return
            if len(group) > 1:
                tel.counter("serve.coalesced_dispatches")
                tel.counter("serve.coalesced_requests", len(group))
            if not cached and block.get("stats") is not None:
                # factor-health sample: the fused [F, 9]
                # sketch rode the block's own module — one sample per
                # block BUILD (cache hits re-serve already-observed
                # data). Materializing it here fronts the same block
                # wait the first answer's fetch pays; no extra wall
                tel.factorplane.observe_block(self.names,
                                              block["stats"],
                                              boundary="serve.block")
            fetched: dict = {}
            ok = True
            answered, failed = [], []
            for p in group:
                t0 = time.perf_counter()
                try:
                    result = self._answer(block, p.query, fetched)
                except Exception as e:  # noqa: BLE001 — per-request
                    tel.counter("serve.failures", stage="answer")
                    self._complete(p, p.query.kind, "error", did,
                                   len(group), block_s,
                                   time.perf_counter() - t0,
                                   t_dispatch, error=e)
                    failed.append((p, e))
                    ok = False
                    continue
                answered.append((p, result, time.perf_counter() - t0))
            # the breaker reads this dispatch's outcome before any member
            # sees its answer, so a caller that got one sees the breaker
            # it left behind
            if ok:
                self._breaker_ok()
            else:
                self._breaker_failure()
            for p, e in failed:
                p.future.set_exception(e)
            self._deliver(answered, did, len(group), block_s, t_dispatch)
        self.flight.note_dispatch({
            "dispatch_id": did, "op": "block", "key": list(key),
            "group_size": len(group), "cache_hit": cached,
            "block_s": round(block_s, 6)})
        tel.hbm.sample("serve.dispatch")
        # micro-batch fill at the serve dispatch boundary:
        # coalesced requests per dispatch vs the configured ceiling
        tel.meshplane.record_occupancy(
            len(group) / max(1, self.scfg.max_batch),
            boundary="serve.dispatch")

    # --- answers (the boundary: device block -> host JSON-able) ---------
    def _days_codes(self, q: Query) -> dict:
        return {"days": list(self.source.days[q.start:q.end]),
                "start": q.start, "end": q.end}

    def _host_exposures(self, block, fetched: dict) -> np.ndarray:
        """The group's ONE host fetch of the stacked exposures (memoised
        across the group's factors-queries) — the boundary fetch of the
        request loop. With
        ``ServeConfig.result_wire`` the fetch ships the blocked-
        quantized payload instead of raw f32 (~half the bytes of the
        copy) and the answer is its host dequantize — byte-identical
        to decoding the same payload anywhere else, and re-encoded from
        the RAW cached block on every dispatch group (never from a
        decode: no double quantization through the exposure cache)."""
        if "exposures" not in fetched:
            if self.scfg.result_wire:
                from ..data import result_wire as _rw
                payload_dev, spec = self.engine.encode_exposures(block)
                payload = _fetch(payload_dev)  # the boundary fetch
                f, d, t = block["exposures"].shape
                dec, v = _rw.decode_block(
                    payload, f, d, t, spec.spill_rows,
                    telemetry=self.telemetry)
                self.telemetry.counter("serve.result_wire_answers")
                self.telemetry.counter("serve.result_wire_bytes",
                                       v["payload_bytes"])
                fetched["exposures"] = dec
            else:
                fetched["exposures"] = _fetch(block["exposures"])
        return fetched["exposures"]

    def _wire_payload(self, block, fetched: dict):
        """The group's ONE host fetch of the PACKED result-wire payload
        (memoised beside the decoded-exposures memo — a mixed group of
        wire and json factors-queries pays at most one fetch of each).
        Encodes from the cached RAW f32 block (never from a decode; no
        double quantization) on a warm callable, so steady-state wire
        traffic builds nothing."""
        if "wire" not in fetched:
            payload_dev, spec = self.engine.encode_exposures(block)
            payload = _fetch(payload_dev)  # the boundary fetch
            self.telemetry.counter("serve.result_wire_answers")
            self.telemetry.counter("serve.result_wire_bytes",
                                   int(payload.nbytes))
            fetched["wire"] = (payload, spec)
        return fetched["wire"]

    def _answer(self, block, q: Query, fetched: dict) -> dict:
        out = self._days_codes(q)
        if q.kind == "factors" and q.encoding == "wire":
            payload, spec = self._wire_payload(block, fetched)
            f, d, t = block["exposures"].shape
            # the payload travels VERBATIM: the HTTP edge frames these
            # bytes (data/result_wire.pack_frame) and the client-side
            # dequantize (serve/wireclient.py) is byte-identical to
            # decoding the same payload here
            out.pop("days", None)
            out.update({
                "wire": True, "payload": payload,
                "n_factors": f, "days": d, "tickers": t,
                "spill_rows": spec.spill_rows,
                "names": list(self.names)})
            return out
        if q.kind == "factors":
            exp = self._host_exposures(block, fetched)
            names = q.names or self.names
            out["codes"] = list(self.source.codes)
            out["exposures"] = {
                n: exp[self.names.index(n)].tolist() for n in names}
            return out
        if q.kind == "ic":
            ic, rank_ic = self.engine.ic(block, q.factor, q.horizon)
            ic = _fetch(ic)
            rank_ic = _fetch(rank_ic)
            out.update({
                "factor": q.factor, "horizon": q.horizon,
                "ic": ic.tolist(), "rank_ic": rank_ic.tolist(),
                "mean_ic": _finite_mean(ic),
                "mean_rank_ic": _finite_mean(rank_ic)})
            # realized-IC health: the IC graph
            # already produced the number whenever horizon data was
            # available — the plane only rolls it per (factor, horizon)
            self.telemetry.factorplane.note_ic(
                q.factor, out["mean_ic"], horizon=q.horizon)
            return out
        _labels, counts, mean_ret = self.engine.decile(
            block, q.factor, q.horizon, q.group_num)
        out.update({
            "factor": q.factor, "horizon": q.horizon,
            "group_num": q.group_num,
            "counts": _fetch(counts).tolist(),
            "mean_fwd_ret": _fetch(mean_ret).tolist()})
        return out


def _indexed(device: torch.device) -> torch.device:
    """A ``cuda`` device without an index as the current one's."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_name(device: torch.device) -> str:
    """The health payload's device label: the card's name after its
    torch device (``cuda:0 NVIDIA H100 80GB HBM3``), or ``cpu``."""
    if device.type != "cuda":
        return str(device)
    try:
        return f"{device} {torch.cuda.get_device_name(device)}"
    except Exception:  # noqa: BLE001 — a label must not fail health
        return str(device)


def _finite_mean(x: np.ndarray):
    f = x[np.isfinite(x)]
    return round(f.mean().tolist(), 8) if f.size else None


class ServeClient:
    """In-process client API — the notebook-facing surface. Each method
    submits one :class:`Query` and blocks on its future."""

    def __init__(self, server: FactorServer,
                 timeout: Optional[float] = 60.0):
        self._server = server
        self._timeout = timeout

    def factors(self, start: int, end: int,
                names: Optional[Sequence[str]] = None) -> dict:
        q = Query("factors", start, end,
                  names=tuple(names) if names else None)
        return self._server.submit(q).result(self._timeout)

    def factors_wire(self, start: int, end: int):
        """The full factor block over ``[start, end)`` through the
        result wire: submits ``encoding='wire'`` and decodes
        the packed payload with the first-party decoder
        (:mod:`.wireclient`) — the same dequantize an HTTP wire client
        runs, so in-process and edge answers are byte-identical by
        construction. Returns ``(exposures [F, D, T], meta)``."""
        from .wireclient import decode_answer
        q = Query("factors", start, end, encoding="wire")
        ans = self._server.submit(q).result(self._timeout)
        return decode_answer(ans, telemetry=self._server.telemetry)

    def ic(self, factor: str, start: int, end: int,
           horizon: int = 1) -> dict:
        q = Query("ic", start, end, factor=factor, horizon=horizon)
        return self._server.submit(q).result(self._timeout)

    def decile(self, factor: str, start: int, end: int,
               horizon: int = 1, group_num: int = 5) -> dict:
        q = Query("decile", start, end, factor=factor, horizon=horizon,
                  group_num=group_num)
        return self._server.submit(q).result(self._timeout)

    def ingest(self, bars, present) -> dict:
        """Advance the streaming carry by ``B`` minutes of bars;
        returns ``{"minute", "bars"}`` once applied."""
        return self._server.ingest(bars, present).result(self._timeout)

    def intraday(self, names: Optional[Sequence[str]] = None) -> dict:
        """The live partial-day exposures + readiness plane."""
        q = Query("intraday", names=tuple(names) if names else None)
        return self._server.submit(q).result(self._timeout)

    def discover(self, start: int, end: int, generations: int = 4,
                 pop: int = 128, seed: int = 0, horizon: int = 1,
                 skeleton: str = "default") -> dict:
        """Run a bounded-generations discovery job and block for its
        answer (the registered name + backtest stats)."""
        return self._server.discover(
            start, end, generations=generations, pop=pop, seed=seed,
            horizon=horizon, skeleton=skeleton).result(self._timeout)

    def factor_list(self) -> dict:
        """Built-in + discovered factor names (``GET /v1/factors``)."""
        return self._server.factor_list()
