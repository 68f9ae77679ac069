"""The streaming engine: a device-resident carry advanced by warm
callables.

The port of the JAX package's ``stream/engine.py``. One
:class:`StreamEngine` owns one day's carry for one ticker universe on one
device and advances it through callables built once and kept in a
:class:`..serve.executables.ExecutableCache` (so a warm engine builds
nothing per bar; the cache's ``serve.executables{outcome=miss}`` counter
is the gate the JAX package's ``xla.compiles`` is there):

* ``stream_update_scan`` — B minutes in one call: :func:`scan_update`,
  a loop over the micro-batch's minutes with
  :func:`..stream.carry.update_minute` as the body (torch has no
  ``lax.scan``);
* ``stream_update_cohort`` — K tickers' bars at the current minute in one
  scatter (the live-feed path), and ``stream_advance``, the cursor step
  at minute boundaries;
* ``stream_snapshot`` (and its ``_wire``/``_stats``/``_wire_stats``
  twins) — stacked ``[F, T]`` partial exposures and the readiness plane
  (:func:`..stream.carry.finalize_with_readiness`), optionally through
  the result wire and with the factor-stats sketch.

Inputs arrive as host numpy and are copied to the engine's device once
per call; outputs stay on the device (the caller fetches). Every
snapshot that serves an ``mmt_ols_*`` factor launches the rolling
second-moment kernel once, on ``[T, S]`` under the partial-day mask.

With ``mesh`` (an in-process :class:`..parallel.local.LocalMesh`,
``parallel.resident_mesh(n, devices=[...])``) the carry is placed over
the mesh's tickers axis, as the JAX package places it with a
``NamedSharding``: every carry leaf whose axis 0 is the ticker count is
cut into contiguous blocks, one a shard, on the shard's device (the
cursor, the only other leaf, is each shard's own host int). Each
callable then runs on every shard's block at once (:meth:`LocalMesh.
run`): an ingest on its tickers' columns, a cohort on the rows routed
to it with local indices (the pad row dropped), a snapshot through
``finalize_with_readiness(xs_axis_name=TICKERS_AXIS)``, whose only
collective is the ``doc_pdf*`` whole-frame rank's gather, with the
result wire's per-slice bounds and the stats sketch reduced over the
shards. The snapshot's ``[F, T]`` planes and the payload are assembled
on the mesh's first device in ticker order, bitwise the unsharded
engine's; each snapshot serving an ``mmt_ols_*`` factor launches the
kernel once a shard, on ``[T/n, S]``.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import result_wire
from ..serve.executables import ExecutableCache
from ..telemetry.factorplane import factor_stats_block
from . import carry as carry_mod


def scan_update(carry, bars_seq, present_seq, session=None):
    """Fold ``B`` minutes into the carry: ``bars_seq [B, T, 5]``,
    ``present_seq [B, T]`` on the carry's device."""
    for b in range(bars_seq.shape[0]):
        carry = carry_mod.update_minute(carry, bars_seq[b], present_seq[b],
                                        session=session)
    return carry


def _snapshot(carry, names, replicate_quirks, rolling_impl, session,
              finalize_impl, result_spec=None, stats=False,
              xs_axis_name=None):
    """One snapshot: ``(exposures or payload, ready[, stats])``. The stats
    read the raw exposures before the encode. ``xs_axis_name``: the carry
    is one shard's ticker block (inside ``with mesh:``), and the wire's
    result is that block's :func:`..data.result_wire.encode_parts`."""
    exposures, ready = carry_mod.finalize_with_readiness(
        carry, names, replicate_quirks, rolling_impl, session=session,
        finalize_impl=finalize_impl, xs_axis_name=xs_axis_name)
    out = exposures
    if result_spec is not None:
        block = exposures[:, None, :]
        out = (result_wire.encode_block(block, result_spec)
               if xs_axis_name is None else
               result_wire.encode_parts(block, result_spec, xs_axis_name))
    if stats:
        return out, ready, factor_stats_block(exposures, xs_axis_name)
    return out, ready


def _upload(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


class StreamEngine:
    """Streaming state and its callables for one ticker universe.

    ``executables`` is injectable so a server can share one cache (and one
    build count) between its engines; standalone use gets its own.
    ``device`` defaults to ``cuda`` and raises when no card is present;
    pass ``device='cpu'`` to run on the CPU. ``mesh`` (an in-process
    mesh, in place of ``device``) places the carry over its tickers
    axis (module docstring); the universe must divide over its shards.
    """

    def __init__(self, n_tickers: int,
                 names: Optional[Sequence[str]] = None,
                 replicate_quirks: bool = True,
                 rolling_impl: Optional[str] = None,
                 telemetry=None,
                 executables: Optional[ExecutableCache] = None,
                 mesh=None, session=None,
                 finalize_impl: Optional[str] = None,
                 device=None):
        from ..config import get_config
        from ..markets import get_session
        from ..models.registry import factor_names
        from ..pipeline import resolve_device
        from ..telemetry import get_telemetry
        from . import fastpath

        self.n_tickers = int(n_tickers)
        #: the in-process tickers mesh the carry is placed over, or None
        self.mesh = mesh
        #: the mesh axis a shard's finalize gathers the doc_pdf* rank over
        self._xs_axis_name = None
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from ..parallel.local import lead_device
            from ..parallel.mesh import TICKERS_AXIS
            #: the lead device: where snapshots are assembled
            self.device = lead_device(mesh, device, "StreamEngine")
            t_shards = mesh.shape[TICKERS_AXIS]
            if self.n_tickers % t_shards:
                raise ValueError(
                    f"n_tickers {self.n_tickers} does not divide over "
                    f"{t_shards} ticker shards: pad the universe first")
            self._xs_axis_name = TICKERS_AXIS
        #: the market session: sizes the day buffer ([T, S, 5]), bounds
        #: the minute cursor and sets the accumulators' window boundaries
        self.session = get_session(session)
        self.names: Tuple[str, ...] = (tuple(names) if names is not None
                                       else factor_names())
        self.replicate_quirks = replicate_quirks
        self.rolling_impl = (rolling_impl if rolling_impl is not None
                             else get_config().rolling_impl)
        #: the requested snapshot finalize (None -> Config.finalize_impl)
        #: and the resolved one: 'fast' with no foldable factor served
        #: resolves 'exact'
        self.finalize_impl = (finalize_impl if finalize_impl is not None
                              else get_config().finalize_impl)
        if self.finalize_impl not in ("exact", "fast"):
            raise ValueError(
                f"unknown finalize_impl {self.finalize_impl!r} "
                "(valid: 'exact', 'fast')")
        fold, _residual = fastpath.partition_names(self.names)
        self.fold_names: Tuple[str, ...] = fold
        self.finalize_impl_resolved = (
            "fast" if self.finalize_impl == "fast" and fold else "exact")
        self.telemetry = (telemetry if telemetry is not None
                          else get_telemetry())
        self.executables = (executables if executables is not None
                            else ExecutableCache(telemetry=telemetry))
        #: the result-wire spec of the snapshots' [F, 1, T] block
        self.result_spec = result_wire.ResultWireSpec.for_names(
            self.names, days=1)
        n_fold = len(fold) if self.finalize_impl_resolved == "fast" else 0
        self.telemetry.gauge("stream.finalize_fold_factors", n_fold)
        self.telemetry.gauge("stream.finalize_residual_factors",
                             len(self.names) - n_fold)
        self.carry = None
        #: host mirror of the minute cursor (no device read for gauges or
        #: over-ingest guards)
        self.minutes = 0
        #: monotone stamp of the last applied ingest; None until one lands
        self._last_ingest_t: Optional[float] = None
        self.reset()

    # --- lifecycle ------------------------------------------------------
    def _graph_key(self):
        place = str(self.device) if self.mesh is None else self.mesh.key()
        return (self.n_tickers, self.names, self.replicate_quirks,
                self.rolling_impl, self.session.name,
                self.finalize_impl_resolved, place)

    def cursor(self) -> dict:
        """Where this engine's carry stands, ``{"minute", "tickers",
        "session"}``, from host mirrors only."""
        return {"minute": self.minutes, "tickers": self.n_tickers,
                "session": self.session.name}

    def staleness_s(self) -> Optional[float]:
        """Seconds since the last applied ingest (monotone clock); None
        until the first ingest lands."""
        t = self._last_ingest_t
        if t is None:
            return None
        return max(0.0, time.monotonic() - t)

    def _put_carry(self, host) -> None:
        """A host carry onto the engine's placement: one copy to the
        device, or each shard's ticker block to its device (the carry is
        then the list of the shards' carries)."""
        if self.mesh is None:
            self.carry = carry_mod.carry_to_device(host, self.device)
            return
        self.carry = self.mesh.run(
            lambda view, h: carry_mod.carry_to_device(h, view.device),
            carry_mod.split_tickers(host, self.mesh.size))

    def reset(self) -> "StreamEngine":
        """A fresh empty-day carry (one host->device copy a shard)."""
        self._put_carry(
            carry_mod.init_carry(self.n_tickers, session=self.session))
        self.minutes = 0
        self._note_carry()
        return self

    def _note_carry(self) -> None:
        tel = self.telemetry
        shards = [self.carry] if self.mesh is None else self.carry
        tel.gauge("stream.carry_bytes",
                  sum(carry_mod.carry_nbytes(c) for c in shards))
        tel.gauge("stream.minute", self.minutes)

    def save(self) -> Dict[str, np.ndarray]:
        """Host copy of the carry (mid-day restart), in the JAX package's
        snapshot format, the whole universe in ticker order under any
        placement."""
        if self.mesh is None:
            return carry_mod.carry_to_host(self.carry)
        return carry_mod.merge_tickers(self.mesh.run(
            lambda view, c: carry_mod.carry_to_host(c), self.carry))

    def restore(self, snapshot: Dict[str, object]) -> "StreamEngine":
        """Adopt a :meth:`save` snapshot (of either package, taken under
        any placement); the continued fold is bitwise the uninterrupted
        one."""
        host = carry_mod.carry_from_host(snapshot)
        if host["mask"].shape[0] != self.n_tickers:
            raise ValueError(
                f"snapshot holds {host['mask'].shape[0]} tickers; engine "
                f"is sized for {self.n_tickers}")
        if host["mask"].shape[1] != self.session.n_slots:
            raise ValueError(
                f"snapshot holds a {host['mask'].shape[1]}-slot day "
                f"buffer; engine runs session "
                f"{self.session.name!r} ({self.session.n_slots} slots)")
        self._put_carry(host)
        self.minutes = int(snapshot["t"])
        self._note_carry()
        return self

    # --- callables ------------------------------------------------------
    def _uses_kernel(self) -> bool:
        return self.device.type == "cuda" and self.rolling_impl == "cuda"

    def _exe(self, label: str, key_extra: tuple, fn):
        """The cached callable for ``label`` at ``key_extra``; a build
        binds ``fn``, loading the kernel library first when the engine
        launches the kernel."""
        def build():
            if self._uses_kernel():
                from .. import kernels
                kernels.load("rolling_moments")
            return fn

        key = (label,) + self._graph_key() + key_extra
        return self.executables.get(label, key, build)

    def _scan_fn(self):
        return functools.partial(scan_update, session=self.session)

    def _cohort_fn(self):
        return functools.partial(carry_mod.update_tickers,
                                 session=self.session)

    def _snapshot_fn(self, result_spec=None, stats=False):
        return functools.partial(
            _snapshot, names=self.names,
            replicate_quirks=self.replicate_quirks,
            rolling_impl=self.rolling_impl, session=self.session,
            finalize_impl=self.finalize_impl_resolved,
            result_spec=result_spec, stats=stats,
            xs_axis_name=self._xs_axis_name)

    def _snapshot_exe(self, label: str, wire: bool, stats: bool):
        spec = self.result_spec if wire else None
        extra = (spec,) if wire else ()
        return self._exe(label, extra, self._snapshot_fn(spec, stats))

    _SNAPSHOTS = (("stream_snapshot", False, False),
                  ("stream_snapshot_stats", False, True),
                  ("stream_snapshot_wire", True, False),
                  ("stream_snapshot_wire_stats", True, True))

    def warmup(self, micro_batches: Sequence[int] = (),
               cohorts: Sequence[int] = (), snapshot: bool = True) -> None:
        """Build every callable the declared load shapes need, and load
        the kernel library; moves no data. After it, ingest and snapshots
        build nothing (``serve.executables{outcome=miss}`` stays flat)."""
        for b in micro_batches:
            self._exe("stream_update_scan", (int(b),), self._scan_fn())
        for k in cohorts:
            self._exe("stream_update_cohort", (int(k),), self._cohort_fn())
        self._exe("stream_advance", (), carry_mod.advance)
        if snapshot:
            for label, wire, stats in self._SNAPSHOTS:
                self._snapshot_exe(label, wire, stats)

    # --- ingest ---------------------------------------------------------
    def ingest_minutes(self, bars: np.ndarray,
                       present: np.ndarray) -> None:
        """Fold ``B`` whole minutes (host arrays ``bars [B, T, 5]``,
        ``present [B, T]``) into the carry in one call."""
        b, t = present.shape
        if t != self.n_tickers:
            raise ValueError(f"got {t} tickers, engine holds "
                             f"{self.n_tickers}")
        if self.minutes + b > self.session.n_slots:
            raise ValueError(
                f"ingesting {b} minutes past slot {self.minutes} "
                f"overruns the {self.session.n_slots}-slot "
                f"{self.session.name} day")
        n_bars = int(present.sum())
        exe = self._exe("stream_update_scan", (b,), self._scan_fn())
        t0 = time.perf_counter()
        if self.mesh is None:
            self.carry = exe(self.carry,
                             _upload(bars, np.float32, self.device),
                             _upload(present, bool, self.device))
        else:
            self.carry = self.mesh.run(
                lambda view, c, bb, pp: exe(
                    c, _upload(bb, np.float32, view.device),
                    _upload(pp, bool, view.device)),
                self.carry, np.split(bars, self.mesh.size, axis=1),
                np.split(present, self.mesh.size, axis=1))
        tel = self.telemetry
        tel.observe("stream.update_seconds",
                    time.perf_counter() - t0, kind="scan")
        tel.counter("stream.updates", kind="scan")
        tel.counter("stream.bars", n_bars)
        # useful-lane fraction of the scan micro-batch
        tel.meshplane.record_occupancy(
            n_bars / (b * t) if b * t else 0.0, boundary="stream.scan")
        self.minutes += b
        self._last_ingest_t = time.monotonic()
        self._note_carry()
        # the memory watermark at the ingest boundary (rate-limited inside
        # the sampler, never raises)
        tel.hbm.sample("stream.ingest")

    def ingest_cohort(self, rows: np.ndarray, idx: np.ndarray) -> None:
        """Scatter ``K`` tickers' bars at the current minute (host arrays
        ``rows [K, 5]`` f32, ``idx [K]`` int32; pad with
        ``idx == n_tickers``). The cursor stays: call :meth:`advance` at
        the minute boundary."""
        if idx.dtype != np.int32:
            raise TypeError(f"idx must be int32, got {idx.dtype}")
        if len(idx) and (idx.min() < 0 or idx.max() > self.n_tickers):
            raise ValueError(
                f"cohort indices must lie in [0, {self.n_tickers}] "
                f"({self.n_tickers} pads); got [{idx.min()}, {idx.max()}]")
        if self.minutes >= self.session.n_slots:
            raise ValueError(
                f"no slot left for a cohort: the {self.session.n_slots}-"
                f"slot {self.session.name} day is full")
        k = len(idx)
        n_real = int((idx < self.n_tickers).sum())
        exe = self._exe("stream_update_cohort", (k,), self._cohort_fn())
        t0 = time.perf_counter()
        if self.mesh is None:
            self.carry = exe(self.carry,
                             _upload(rows, np.float32, self.device),
                             _upload(idx, np.int64, self.device))
        else:
            # every shard takes all K rows: those of its tickers at their
            # local index, the rest (and the pads) at its own pad index
            blk = self.n_tickers // self.mesh.size
            local = [np.where((idx >= i * blk) & (idx < (i + 1) * blk),
                              idx - i * blk, blk)
                     for i in range(self.mesh.size)]
            self.carry = self.mesh.run(
                lambda view, c, li: exe(
                    c, _upload(rows, np.float32, view.device),
                    _upload(li, np.int64, view.device)),
                self.carry, local)
        tel = self.telemetry
        tel.observe("stream.update_seconds",
                    time.perf_counter() - t0, kind="cohort")
        tel.counter("stream.updates", kind="cohort")
        tel.counter("stream.bars", n_real)
        # real rows per K-row scatter: the cohort callable pays for K
        # lanes regardless, so a mostly padded feed shows here
        tel.meshplane.record_occupancy(n_real / k if k else 0.0,
                                       boundary="stream.cohort")
        self._last_ingest_t = time.monotonic()
        tel.hbm.sample("stream.ingest")

    def advance(self) -> None:
        """Close the current minute (the cohort path's minute boundary)."""
        if self.minutes + 1 > self.session.n_slots:
            raise ValueError(
                f"advancing past the {self.session.n_slots}-slot "
                f"{self.session.name} day")
        exe = self._exe("stream_advance", (), carry_mod.advance)
        # the cursor is host state: no device work, on any placement
        self.carry = (exe(self.carry) if self.mesh is None
                      else [exe(c) for c in self.carry])
        self.telemetry.counter("stream.updates", kind="advance")
        self.minutes += 1
        self._note_carry()

    # --- snapshot -------------------------------------------------------
    def _snap(self, label: str, wire: bool, stats: bool):
        exe = self._snapshot_exe(label, wire, stats)
        t0 = time.perf_counter()
        if self.mesh is None:
            out = exe(self.carry)
        else:
            out = self._assemble(self.mesh.run(lambda view, c: exe(c),
                                               self.carry), wire, stats)
        tel = self.telemetry
        tel.observe("stream.snapshot_seconds", time.perf_counter() - t0)
        if wire:
            tel.counter("stream.snapshots", kind="wire")
        else:
            tel.counter("stream.snapshots")
        tel.counter("stream.finalize_snapshots",
                    impl=self.finalize_impl_resolved)
        tel.hbm.sample("stream.snapshot")
        return out

    def _assemble(self, outs, wire: bool, stats: bool):
        """The shards' snapshot outputs as one on the lead device: the
        ``[F, T]`` planes and the payload joined in ticker order, the
        stats (the same on every shard) from the first."""
        lead = self.device

        def join(i):
            return torch.cat([o[i].to(lead) for o in outs], dim=-1)

        if wire:
            first = result_wire.join_ticker_blocks(
                [[t.to(lead) for t in o[0]] for o in outs])
        else:
            first = join(0)
        if stats:
            return first, join(1), outs[0][2].to(lead)
        return first, join(1)

    def snapshot(self):
        """The partial day on the device: ``(exposures [F, T],
        ready [F, T])``."""
        return self._snap("stream_snapshot", False, False)

    def snapshot_wire(self):
        """The partial day through the result wire: ``(payload [L] u8,
        ready [F, T])`` on the device. Decode a fetched payload with
        ``data.result_wire.decode_block(payload, F, 1, T,
        engine.result_spec.spill_rows)``."""
        return self._snap("stream_snapshot_wire", True, False)

    def snapshot_stats(self):
        """:meth:`snapshot` with the ``[F, 9]`` factor-stats sketch as a
        third output; exposures and readiness are the plain snapshot's
        bits."""
        return self._snap("stream_snapshot_stats", False, True)

    def snapshot_wire_stats(self):
        """:meth:`snapshot_wire` with the stats sketch of the raw
        exposures, taken before the encode: ``(payload, ready, stats)``."""
        return self._snap("stream_snapshot_wire_stats", True, True)
