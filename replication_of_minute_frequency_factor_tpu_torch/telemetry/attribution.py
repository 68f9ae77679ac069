"""Performance attribution: guaranteed profiler capture, trace
post-processing and wall-clock reconciliation.

The port of the JAX package's ``telemetry/attribution.py``. It turns "the
run took N seconds" into "N seconds = these stages + these op classes,
with an explicit unattributed residual":

* :class:`TraceCapture` — a crash-safe context manager around one
  ``torch.profiler`` session (CPU activities, plus CUDA activities on a
  card) that exports a Chrome trace (``*.trace.json``) into the profile
  directory on EVERY exit path, and records start/stop failures as
  metrics instead of letting diagnostics kill work.
* trace post-processing — :func:`load_trace_events` /
  :func:`device_op_breakdown` / :func:`stage_annotation_totals` parse
  Chrome ``trace_events`` JSON (what ``torch.profiler`` exports, what the
  JAX package's ``jax.profiler`` writes, and what
  :meth:`..spans.SpanTracer.write_chrome_trace` exports) into a
  per-op-class device-time breakdown plus per-stage annotation totals.
* reconciliation — :func:`reconcile` compares ``sum(stages)`` against a
  measured wall clock and reports the ``unattributed_s`` residual
  explicitly, flagging (or, in strict mode, raising on) runs where more
  than ``tolerance`` of the wall is unaccounted for. Stage overlap
  (pipelined producer/consumer threads) legitimately makes the sum
  EXCEED the wall; that surplus is reported as ``overlap_s`` and never
  flagged — only *missing* attribution is a measurement gap.

The JAX package's XLA compile/cost telemetry (``compile_with_telemetry``,
``install_compile_listeners``, ``xla_summary``, ``hlo_op_counts``) has no
counterpart: eager torch lowers and compiles nothing, and the run
manifest's ``executables`` block stands in for the compile story.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.logging import get_logger

logger = get_logger(__name__)

#: attribution report schema (the JAX package's ``REPORT_SCHEMA``)
REPORT_SCHEMA = 1

#: default fraction of wall time allowed to stay unattributed
DEFAULT_TOLERANCE = 0.10
#: unattributed seconds never flagged: micro-runs carry a few ms of
#: interpreter slack between stages that is 50% of a 10 ms wall and 0% of
#: any real one
FLOOR_S = 0.05


def _tel(telemetry=None):
    if telemetry is not None:
        return telemetry
    from . import get_telemetry

    return get_telemetry()


# --------------------------------------------------------------------------
# TraceCapture
# --------------------------------------------------------------------------

#: held while a :class:`TraceCapture` session runs: torch reports no
#: session that profiles every thread (``torch.autograd._profiler_enabled``
#: is False during one), and a second session started beside it would end
#: it at its own stop
_SESSION = threading.Lock()


class TraceCapture:
    """Crash-safe ``torch.profiler`` capture window.

    ``with TraceCapture(cfg.profile_dir):`` starts a profiler session on
    entry (a None/empty dir makes the whole manager a no-op) and
    GUARANTEES that it stops and exports its Chrome trace into the
    directory as ``<host>_<pid>_<ns>.trace.json`` on every exit path —
    normal return, body exception, or per-day failure isolation inside
    the body. The session records CPU activities on every thread, and
    CUDA activities when a card is present. Start/stop failures are
    recorded as ``attribution.trace_start_failures`` /
    ``attribution.trace_stop_failures`` counters and never mask the
    body's own exception: profiling is diagnostics, and diagnostics must
    not change a run's fate. A process has one profiler, so a capture
    opened while another session runs (a capture inside a capture, or a
    caller's own ``torch.profiler``) fails to start: torch would let the
    inner session end the outer one.
    """

    def __init__(self, profile_dir: Optional[str], telemetry=None,
                 timer=None):
        #: ``timer`` (a Timer/StageTimer) attributes the capture's OWN
        #: cost — the profiler's set-up and the trace export are
        #: seconds-scale on a large run, and without a named
        #: ``trace_capture`` stage every profiled run would carry a
        #: phantom unattributed residual exactly when measuring it
        #: matters most
        self.profile_dir = profile_dir or None
        self._telemetry = telemetry
        self._timer = timer
        self._prof = None
        self.active = False
        #: the exported trace file of the last capture (None before)
        self.path: Optional[str] = None

    def _timed(self):
        return (self._timer("trace_capture") if self._timer is not None
                else contextlib.nullcontext())

    def __enter__(self) -> "TraceCapture":
        if not self.profile_dir:
            return self
        tel = _tel(self._telemetry)
        held = False
        try:
            with self._timed():
                import torch

                held = _SESSION.acquire(blocking=False)
                if not held or torch.autograd._profiler_enabled():
                    raise RuntimeError(
                        "a torch.profiler session is already running in "
                        "this process")
                os.makedirs(self.profile_dir, exist_ok=True)
                from torch._C._profiler import _ExperimentalConfig
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                # every thread: the driver's producer thread runs the
                # io/grid/wire_encode/pack stages
                prof = profile(activities=acts,
                               experimental_config=_ExperimentalConfig(
                                   profile_all_threads=True))
                prof.start()
            self._prof = prof
            self.active = True
            tel.counter("attribution.trace_captures")
            tel.event("trace_capture_started", dir=str(self.profile_dir))
        except Exception as e:  # noqa: BLE001 — diagnostics must not kill work
            if held:
                _SESSION.release()
            tel.counter("attribution.trace_start_failures")
            tel.event("trace_start_failed", dir=str(self.profile_dir),
                      error=f"{type(e).__name__}: {e}")
            logger.warning("profiler trace start failed for %s: %s",
                           self.profile_dir, e)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self.active:
            return False
        self.active = False
        prof, self._prof = self._prof, None
        tel = _tel(self._telemetry)
        try:
            with self._timed():
                try:
                    prof.stop()
                finally:
                    _SESSION.release()
                path = os.path.join(
                    self.profile_dir,
                    f"{socket.gethostname()}_{os.getpid()}_"
                    f"{time.time_ns()}.trace.json")
                prof.export_chrome_trace(path)
            self.path = path
        except Exception as e:  # noqa: BLE001 — never mask the body's error
            tel.counter("attribution.trace_stop_failures")
            tel.event("trace_stop_failed", dir=str(self.profile_dir),
                      error=f"{type(e).__name__}: {e}")
            logger.warning("profiler trace stop failed for %s: %s",
                           self.profile_dir, e)
        return False


# --------------------------------------------------------------------------
# Trace post-processing
# --------------------------------------------------------------------------

#: op-class patterns, FIRST match wins (order matters: 'all-reduce'
#: must classify as collective before 'reduce' claims it, 'copy-start'
#: as transfer before 'copy' claims it). The JAX package's XLA op names
#: plus the names CUDA and ATen put in a torch trace:
#: ``Memcpy HtoD``/``DtoH`` are the host transfers (``infeed_outfeed``);
#: ``Memcpy DtoD``/``Memset``, ATen's gathers, scatters, flips and
#: concatenations (``index_elementwise_kernel``,
#: ``_scatter_gather_elementwise_kernel``, ``CatArrayBatchedCopy``) and
#: its copies, casts and fills (``direct_copy_kernel_cuda``,
#: ``FillFunctor``, though they run as elementwise kernels) move data
#: (``data_movement``); every other ATen pointwise kernel
#: (``elementwise_kernel``, ``vectorized_elementwise_kernel``,
#: ``unrolled_elementwise_kernel``) is one eager op of what XLA would
#: fuse into a loop fusion, so it is ``fusion``; cuBLAS/CUTLASS products
#: are ``matmul_conv``; CUB sorts and scans and ATen's sort, scan,
#: search and top-k kernels ``sort_scan``; ``reduce_kernel`` and
#: ``reduction_*`` ``reduction``; NCCL ``collective``. The port's own
#: kernel (``second_moments_tiled_kernel``) is ``other``, as a Pallas
#: kernel is in a JAX trace.
OP_CLASS_PATTERNS: Tuple[Tuple[str, "re.Pattern"], ...] = tuple(
    (cls, re.compile(pat, re.IGNORECASE)) for cls, pat in (
        ("collective", r"all-?reduce|all-?gather|all-?to-?all|"
                       r"reduce-?scatter|collective-?permute|\bpsum\b|"
                       r"nccl"),
        ("infeed_outfeed", r"infeed|outfeed|copy-start|copy-done|"
                           r"\bh2d\b|\bd2h\b|transfer|memcpy htod|"
                           r"memcpy dtoh"),
        ("data_movement", r"memcpy dtod|memset|index_elementwise|"
                          r"scatter_gather|catarray|indexselect|"
                          r"index_select|direct_copy_kernel|fillfunctor|"
                          r"fill_reverse_indices"),
        ("sort_scan", r"cub::|radixsort|devicescan|sort|_scan_|scan_|"
                      r"topk"),
        ("fusion", r"^fusion|\bfused\b|elementwise_kernel"),
        ("matmul_conv", r"^dot\b|\bdot\.|dot-|convolution|\bgemm\b|"
                        r"matmul|einsum|gemm|cutlass|cublas|xmma"),
        ("sort_scan", r"\bsort\b|while|top-?k|cumsum"),
        ("reduction", r"reduce|arg-?max|arg-?min|reduction_"),
        ("data_movement", r"copy|transpose|reshape|broadcast|concat|"
                          r"slice|\bpad\b|gather|scatter|select|iota|"
                          r"bitcast|convert"),
    ))

#: span names the pipeline and the JAX package's bench annotate
#: (StageTimer and ``trace_annotation`` open
#: ``torch.profiler.record_function`` regions, which a torch trace carries
#: as ``user_annotation`` events)
KNOWN_STAGE_NAMES = (
    "io", "grid", "wire_encode", "pack", "launch", "device",
    "trace_capture", "factor_batch", "synth_batch", "ingest_put",
    "compile", "device_exec_first", "device_exec_steady",
    "result_to_host",
)

#: Chrome-trace categories of work on the card in a torch trace
#: (kernels, copies, fills); its other categories are host-side
#: (``cpu_op``, ``cuda_runtime``, ``user_annotation``) or the device
#: timeline's projection of host annotations (``gpu_user_annotation``)
DEVICE_EVENT_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def classify_op(name: str) -> str:
    """Op-class of one trace-event name; ``other`` when nothing matches."""
    for cls, pat in OP_CLASS_PATTERNS:
        if pat.search(name):
            return cls
    return "other"


#: canonical collective kinds WITHIN the 'collective' op class. First
#: match wins; anything the class pattern caught but these don't lands
#: in ``other_collective``.
COLLECTIVE_KIND_PATTERNS: Tuple[Tuple[str, "re.Pattern"], ...] = tuple(
    (kind, re.compile(pat, re.IGNORECASE)) for kind, pat in (
        ("all_gather", r"all-?gather"),
        ("reduce_scatter", r"reduce-?scatter"),
        ("all_reduce", r"all-?reduce|\bpsum\b|\bpmin\b|\bpmax\b"),
        ("all_to_all", r"all-?to-?all"),
        ("collective_permute", r"collective-?permute"),
    ))


def classify_collective(name: str) -> str:
    """Canonical collective kind of one collective-class op name."""
    for kind, pat in COLLECTIVE_KIND_PATTERNS:
        if pat.search(name):
            return kind
    return "other_collective"


def _is_device_process(name: str) -> bool:
    n = name.lower()
    return ("/device:" in n or n.startswith("tpu") or n.startswith("gpu")
            or "xla:#global" in n)


def _device_pids(processes: Dict[int, str]) -> set:
    return {pid for pid, name in processes.items()
            if _is_device_process(name)}


def _device_events(events: Sequence[dict], processes: Dict[int, str]):
    """``(name, dur)`` of each complete ('X') event of work on a device:
    a torch trace marks it by category (:data:`DEVICE_EVENT_CATS`), a
    JAX trace by the process it sits on (pid named like
    ``/device:TPU:0``). An event with another category is host work or an
    annotation, wherever it sits."""
    dev_pids = _device_pids(processes)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat is None:
            if e.get("pid") not in dev_pids:
                continue
        elif cat not in DEVICE_EVENT_CATS:
            continue
        dur = e.get("dur")
        name = e.get("name")
        if not isinstance(dur, (int, float)) or not isinstance(name, str):
            continue
        yield name, float(dur)


def collective_breakdown(events: Sequence[dict],
                         processes: Dict[int, str]) -> dict:
    """On-device collective attribution: total + per-kind device time of
    collective-class ops (the ON-DEVICE counterpart of the host-side
    ``collective.*`` dispatch spans)."""
    by_kind: Dict[str, float] = {}
    n = 0
    for name, dur in _device_events(events, processes):
        if classify_op(name) != "collective":
            continue
        n += 1
        kind = classify_collective(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + dur
    return {
        "collective_events": n,
        "total_collective_us": round(sum(by_kind.values()), 1),
        "by_kind_us": {k: round(v, 1)
                       for k, v in sorted(by_kind.items(),
                                          key=lambda kv: kv[1],
                                          reverse=True)},
    }


def find_trace_files(root: str) -> List[str]:
    """Chrome-trace files under ``root`` (recursive): the profilers'
    ``*.trace.json[.gz]`` and the span export's ``trace.json``."""
    out: List[str] = []
    for r, _, fs in os.walk(root):
        for f in fs:
            if (f.endswith(".trace.json.gz") or f.endswith(".trace.json")
                    or f == "trace.json"):
                out.append(os.path.join(r, f))
    return sorted(out)


def load_trace_events(path: str) -> Tuple[List[dict], Dict[int, str]]:
    """Events + pid->process-name map from ONE Chrome trace JSON file
    (gzipped or plain). Returns ``([], {})`` on an unreadable file —
    post-processing is best-effort over whatever the capture left."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        logger.warning("unreadable trace file %s: %s", path, e)
        return [], {}
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    procs: Dict[int, str] = {}
    for e in events:
        if (isinstance(e, dict) and e.get("ph") == "M"
                and e.get("name") == "process_name"):
            name = (e.get("args") or {}).get("name")
            if name is not None and e.get("pid") is not None:
                procs[e["pid"]] = str(name)
    return [e for e in events if isinstance(e, dict)], procs


#: an XLA op instance suffix (``fusion.12``); CUDA kernel names keep
#: their dots
_INSTANCE_SUFFIX = re.compile(r"\.\d+$")


def device_op_breakdown(events: Sequence[dict],
                        processes: Dict[int, str],
                        top_n: Optional[int] = 15) -> dict:
    """Per-op-class device-time totals from complete ('X') events of work
    on a device (see :func:`_device_events`); host-side frames would
    otherwise swamp the totals. A capture with no device work (a CPU
    run) yields zeroed totals, so callers can tell "no device time" from
    "no device visibility". ``top_ops_us`` lists the ``top_n`` ops by
    time (all of them when None)."""
    by_class: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    n_events = 0
    for name, dur in _device_events(events, processes):
        n_events += 1
        cls = classify_op(name)
        by_class[cls] = by_class.get(cls, 0.0) + dur
        # strip the .N instance suffix so repeated XLA ops aggregate
        op = _INSTANCE_SUFFIX.sub("", name)
        by_op[op] = by_op.get(op, 0.0) + dur
    total = sum(by_class.values())
    top = sorted(by_op.items(), key=lambda kv: kv[1], reverse=True)
    if top_n is not None:
        top = top[:top_n]
    return {
        "device_pids": sorted(processes[p] for p in _device_pids(processes)),
        "device_events": n_events,
        "total_device_us": round(total, 1),
        "by_class_us": {k: round(v, 1)
                        for k, v in sorted(by_class.items(),
                                           key=lambda kv: kv[1],
                                           reverse=True)},
        "top_ops_us": [{"op": k, "us": round(v, 1)} for k, v in top],
    }


def stage_annotation_totals(events: Sequence[dict],
                            stage_names: Sequence[str] = KNOWN_STAGE_NAMES,
                            ) -> Dict[str, float]:
    """Total duration (us) of every known stage/span annotation in a
    capture, regardless of which process carries it — the
    ``record_function`` spans the pipeline emits, the join key between
    the profiler's view and the span export's. A torch trace also
    projects each annotation onto the device timeline
    (``gpu_user_annotation``); only the host's count."""
    want = set(stage_names)
    out: Dict[str, float] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in want \
                and e.get("cat") != "gpu_user_annotation" \
                and isinstance(e.get("dur"), (int, float)):
            out[e["name"]] = out.get(e["name"], 0.0) + float(e["dur"])
    return {k: round(v, 1) for k, v in out.items()}


def summarize_trace_dir(profile_dir: str,
                        top_n: Optional[int] = 15) -> dict:
    """Post-process every trace file under ``profile_dir`` into one
    merged summary (file count, device op-class breakdown with the
    ``top_n`` ops, stage annotation totals)."""
    files = find_trace_files(profile_dir)
    all_events: List[dict] = []
    procs: Dict[int, str] = {}
    for f in files:
        ev, pr = load_trace_events(f)
        all_events.extend(ev)
        procs.update(pr)
    return {
        "profile_dir": profile_dir,
        "files": len(files),
        "events": len(all_events),
        "device_breakdown": device_op_breakdown(all_events, procs, top_n),
        "collective_breakdown": collective_breakdown(all_events, procs),
        "stage_annotations_us": stage_annotation_totals(all_events),
    }


def device_time_block(profile_dir: str, telemetry=None) -> dict:
    """The per-op-class device-time block of a captured profile dir:
    class totals in SECONDS plus the collective attribution.
    ``available`` is the explicit marker — a capture with no device work
    (a CPU run) yields ``available: false`` with zeroed totals, so a CPU
    run can never be read as a measured device-time breakdown (the same
    contract as ``hbm.available``). With a ``telemetry``, the totals also
    land as ``device.device_time_s{class=}`` /
    ``device.collective_time_s{op=}`` gauges."""
    s = summarize_trace_dir(profile_dir)
    db = s["device_breakdown"]
    cb = s["collective_breakdown"]
    block = {
        "profile_dir": profile_dir,
        "files": s["files"],
        "available": db["device_events"] > 0,
        "device_events": db["device_events"],
        "device_time_s": round(db["total_device_us"] / 1e6, 6),
        "by_class_s": {k: round(v / 1e6, 6)
                       for k, v in db["by_class_us"].items()},
        "collective_time_s": round(cb["total_collective_us"] / 1e6, 6),
        "collectives": {k: round(v / 1e6, 6)
                        for k, v in cb["by_kind_us"].items()},
    }
    if telemetry is not None and block["available"]:
        for cls, v in block["by_class_s"].items():
            telemetry.gauge("device.device_time_s", v, **{"class": cls})
        telemetry.gauge("device.collective_time_s",
                        block["collective_time_s"])
        for op, v in block["collectives"].items():
            telemetry.gauge("device.collective_time_s", v, op=op)
    return block


# --------------------------------------------------------------------------
# Wall-clock reconciliation
# --------------------------------------------------------------------------


class ReconciliationError(RuntimeError):
    """Raised in strict mode when too much wall time is unattributed."""


def reconcile(wall_s: float, stages: Optional[Dict[str, float]],
              tolerance: float = DEFAULT_TOLERANCE,
              floor_s: float = FLOOR_S, strict: bool = False) -> dict:
    """``sum(stages)`` vs ``wall_s`` with an explicit residual.

    Non-seconds entries (``*_ms``, ``*_MB``, booleans, non-numbers) are
    dropped so callers can pass a phases/stages dict verbatim.
    ``unattributed_s`` is the wall time NO stage accounts for
    (``max(0, wall - sum)``); ``overlap_s`` is the surplus when
    concurrent stages sum past the wall (expected in the pipelined
    loops, never flagged). ``ok`` is False when the unattributed
    fraction exceeds ``tolerance`` AND the residual exceeds ``floor_s``;
    ``strict=True`` raises :class:`ReconciliationError` instead.
    """
    comp = {}
    for k, v in (stages or {}).items():
        if (isinstance(v, (int, float)) and not isinstance(v, bool)
                and not k.endswith("_ms") and not k.endswith("_MB")):
            comp[k] = float(v)
    attributed = sum(comp.values())
    wall = float(wall_s)
    unattributed = max(0.0, wall - attributed)
    overlap = max(0.0, attributed - wall)
    frac = (unattributed / wall) if wall > 0 else 0.0
    ok = frac <= tolerance or unattributed <= floor_s
    block = {
        "wall_s": round(wall, 3),
        "attributed_s": round(attributed, 3),
        "unattributed_s": round(unattributed, 3),
        "overlap_s": round(overlap, 3),
        "unattributed_frac": round(frac, 4),
        "tolerance": tolerance,
        "stages": {k: round(v, 3) for k, v in comp.items()},
        "ok": ok,
    }
    if strict and not ok:
        raise ReconciliationError(
            f"wall-clock reconciliation failed: {unattributed:.2f}s of "
            f"{wall:.2f}s ({frac:.0%}) unattributed (> {tolerance:.0%} "
            f"tolerance); stages: {block['stages']}")
    return block


def build_report(stages: Optional[Dict[str, float]],
                 wall_s: Optional[float] = None,
                 reconciliation: Optional[dict] = None,
                 profile_dir: Optional[str] = None,
                 tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Full attribution report: reconciliation block (computed from
    ``wall_s`` unless a precomputed one is passed) plus — when a
    ``profile_dir`` is given — the post-processed trace summary."""
    if reconciliation is None:
        reconciliation = reconcile(wall_s or 0.0, stages, tolerance)
    report = {
        "schema": REPORT_SCHEMA,
        "stages_s": {k: round(float(v), 3)
                     for k, v in (stages or {}).items()
                     if isinstance(v, (int, float))},
        "reconciliation": reconciliation,
    }
    if profile_dir:
        report["trace"] = summarize_trace_dir(profile_dir)
    return report


def write_report(path: str, report: dict) -> str:
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1)
    return path
