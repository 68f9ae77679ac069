"""Multihost telemetry aggregation: N per-host bundles -> one pod
bundle (the port's copy of the JAX package's ``aggregate``).

    python -m replication_of_minute_frequency_factor_tpu_torch.telemetry.aggregate \\
        host0/ host1/ ... --out pod/

A multihost run writes one telemetry bundle PER PROCESS (each stamped
with the schema-v3 ``process_index``/``host`` identity by
``Telemetry.write``). This module merges them into one coherent
pod-level bundle:

* **registries merge exactly** — each host's counter/gauge/histogram
  records are reconstituted into a :class:`..registry.MetricsRegistry`
  (``ingest_record``) and folded through the deep-copy
  ``merge``: pod counter totals and histogram counts/sums EQUAL the
  per-host sums by construction (the acceptance property the
  meshplane smoke re-verifies); merged percentiles are approximate
  (reconstituted from each host's persisted order statistics) and the
  pod manifest says so.
* **streams concatenate with provenance** — every span/event/request
  record re-emits into the pod ``metrics.jsonl`` carrying its host's
  identity stamps (original stamps win; unstamped legacy records get
  their bundle's), and every line re-validates through the schema on
  the way out — an aggregate of valid bundles is a valid bundle.
* **traces merge** — per-host Chrome ``trace_events`` land in one
  ``trace.json`` with pids remapped per host (two hosts' pid 1234
  must not interleave as one track) and ``process_name`` metadata
  naming each track's host.
* **flight dumps ride along** — each host's ``flight_*.jsonl`` copies
  into the pod bundle under a host-prefixed name, so the directory
  validator checks them too.
* **timelines fold onto one pod clock** — per-host
  schema-v4 ``frame`` records re-emit with provenance AND fold by
  ``seq`` into pod frames stamped ``host="pod"``: ``rate:`` series
  sum exactly (re-verified like counter totals), gauges/quantiles
  fold as max (documented approximate, like merged percentiles).
* **per-host skew summary** — the pod manifest's ``aggregate`` block
  reports per-host record/span totals and a max/median skew ratio
  over the hosts' attributed span seconds (the pod-level twin of
  ``mesh.shard_skew_ratio``): which HOST was the straggler.

The CLI prints ONE machine-readable JSON verdict line (the
``validate``/``regress`` convention) and exits non-zero when
aggregation failed or the emitted pod bundle does not re-validate.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional, Tuple

from .registry import MetricsRegistry
from .sink import EventSink

#: record kinds that are per-metric state (merged via the registry)
_METRIC_KINDS = frozenset({"counter", "gauge", "histogram"})

#: record kinds re-emitted verbatim (plus identity stamps) into the pod
#: stream; ``manifest`` is rebuilt, not copied. ``frame``/``slo``
#: keep their per-host provenance this way AND fold into
#: the pod timeline below.
_STREAM_KINDS = frozenset({"span", "event", "request", "dump",
                           "frame", "slo"})

#: envelope fields the sink re-stamps itself — everything else of an
#: input record passes through emit() as-is
_ENVELOPE = ("schema", "kind")


class AggregateError(ValueError):
    """An input bundle is missing/unreadable — nothing to merge."""


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def load_bundle(path: str) -> dict:
    """One host bundle off disk: manifest + decoded metrics records +
    trace events + flight-dump paths. Raises :class:`AggregateError`
    on a missing manifest/metrics stream (an aggregate quietly built
    from half a pod would be worse than a loud failure)."""
    mpath = os.path.join(path, "manifest.json")
    jpath = os.path.join(path, "metrics.jsonl")
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        raise AggregateError(f"{mpath}: {e}") from e
    records: List[dict] = []
    try:
        with open(jpath) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    raise AggregateError(f"{jpath}: {e}") from e
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError as e:
        raise AggregateError(f"{jpath}: {e}") from e
    events: List[dict] = []
    try:
        with open(os.path.join(path, "trace.json")) as fh:
            doc = json.load(fh)
        if isinstance(doc, dict) and isinstance(doc.get("traceEvents"),
                                                list):
            events = [e for e in doc["traceEvents"]
                      if isinstance(e, dict)]
    except (OSError, ValueError):
        pass  # a bundle without a trace still merges
    return {
        "path": path,
        "manifest": manifest,
        "records": records,
        "trace_events": events,
        "flights": sorted(glob.glob(os.path.join(path,
                                                 "flight_*.jsonl"))),
    }


def _identity(bundle: dict, position: int) -> Tuple[int, str]:
    """(process_index, host) of one bundle: the manifest's v3 stamps,
    else the first stamped record, else the CLI position."""
    m = bundle["manifest"]
    idx = m.get("process_index")
    host = m.get("host")
    if not isinstance(idx, int) or isinstance(idx, bool):
        idx = next((r["process_index"] for r in bundle["records"]
                    if isinstance(r.get("process_index"), int)
                    and not isinstance(r.get("process_index"), bool)),
                   position)
    if not isinstance(host, str) or not host:
        host = next((r["host"] for r in bundle["records"]
                     if isinstance(r.get("host"), str)),
                    f"host{position}")
    return int(idx), str(host)


def merge_registries(regs) -> MetricsRegistry:
    """THE registry-merge fold: N registries -> one pod registry via
    the deep-copy :meth:`..registry.MetricsRegistry.merge`
    (counters/histogram counts+sums exact per-source sums, gauges
    last-write-wins, percentiles approximate)."""
    merged = MetricsRegistry()
    for reg in regs:
        merged.merge(reg)
    return merged


def registry_of(bundle: dict) -> MetricsRegistry:
    """Reconstitute one host's registry from its persisted metric
    records."""
    reg = MetricsRegistry()
    for rec in bundle["records"]:
        if rec.get("kind") in _METRIC_KINDS:
            try:
                reg.ingest_record(rec)
            except (KeyError, TypeError, ValueError):
                pass  # schema-invalid metric line; the verdict counts
    return reg


def _host_summary(bundle: dict, reg: MetricsRegistry) -> dict:
    """Per-host digest for the pod manifest's skew table."""
    snap = reg.snapshot()
    span_s = sum(st["sum"] for k, st in snap["histograms"].items()
                 if k.startswith("span_seconds"))
    return {
        "path": bundle["path"],
        "records": len(bundle["records"]),
        "counters": len(snap["counters"]),
        "histograms": len(snap["histograms"]),
        "span_seconds_s": round(span_s, 9),
        "flight_dumps": len(bundle["flights"]),
    }


def host_skew(per_host: Dict[str, dict]) -> Optional[dict]:
    """max/median skew over the hosts' attributed span seconds — the
    pod-level straggler indicator (None when fewer than two hosts
    carry span data)."""
    spans = {h: s["span_seconds_s"] for h, s in per_host.items()
             if s.get("span_seconds_s", 0) > 0}
    if len(spans) < 2:
        return None
    med = _median(list(spans.values()))
    worst = max(spans, key=spans.get)
    return {
        "metric": "span_seconds.sum",
        "ratio": round(spans[worst] / med, 4) if med > 0 else 1.0,
        "slow_host": worst,
        "per_host_s": {h: round(v, 9) for h, v in spans.items()},
    }


def fold_timelines(per_host_frames: List[List[dict]]) -> List[dict]:
    """N per-host timeline frame streams -> one pod timeline, aligned
    by ``seq`` (each host's sampler counts frames on its own monotone
    clock; the samplers run at the same period, so frame
    k of every host covers the same slice of pod time — the same
    alignment assumption the cross-host skew table makes explicit).

    Series fold by prefix: ``rate:`` series SUM (a pod request rate is
    the sum of replica rates — exact, re-verified by the caller);
    ``gauge:``/``p50:``/``p95:``/``p99:`` series fold as MAX (a pod's
    staleness is its worst replica's; a pod p99 is at least its worst
    replica's p99 — approximate and documented, like merged histogram
    percentiles). Returns pod frame record dicts (sink field shape)."""
    by_seq: Dict[int, List[dict]] = {}
    for frames in per_host_frames:
        for f in frames:
            seq = f.get("seq")
            if isinstance(seq, int) and not isinstance(seq, bool):
                by_seq.setdefault(seq, []).append(f)
    out = []
    for seq in sorted(by_seq):
        members = by_seq[seq]
        series: Dict[str, float] = {}
        for f in members:
            for key, v in (f.get("series") or {}).items():
                if not isinstance(v, (int, float)) \
                        or isinstance(v, bool):
                    continue
                if key.startswith("rate:"):
                    series[key] = series.get(key, 0.0) + float(v)
                else:
                    series[key] = max(series.get(key, float(v)),
                                      float(v))
        out.append({
            "seq": seq,
            "ts": max(float(f.get("ts", 0.0)) for f in members),
            "interval_s": max(float(f.get("interval_s", 0.0))
                              for f in members),
            "series": series,
        })
    return out


def aggregate_dirs(dirs: List[str], out_dir: str) -> dict:
    """Merge per-host bundles under ``dirs`` into one pod bundle at
    ``out_dir``; returns the verdict dict (see module docstring)."""
    if not dirs:
        raise AggregateError("no input bundle directories")
    bundles = [load_bundle(d) for d in dirs]
    idents = [_identity(b, i) for i, b in enumerate(bundles)]
    # duplicate process indices (two copies of the same host bundle)
    # would double pod counters silently — refuse
    if len({i for i, _ in idents}) != len(idents):
        raise AggregateError(
            f"duplicate process_index among inputs: {idents}")

    regs = [registry_of(b) for b in bundles]
    merged = merge_registries(regs)  # the deep-copy merge

    per_host = {}
    for (idx, host), b, reg in zip(idents, bundles, regs):
        per_host[f"{idx}:{host}"] = _host_summary(b, reg)
    skew = host_skew(per_host)

    os.makedirs(out_dir, exist_ok=True)
    # --- pod manifest: host 0's provenance + the aggregate block
    base = dict(bundles[0]["manifest"])
    from .sink import SCHEMA_VERSION
    base["schema"] = SCHEMA_VERSION
    base["aggregate"] = {
        "bundles": len(bundles),
        "hosts": [{"process_index": i, "host": h, "path": b["path"]}
                  for (i, h), b in zip(idents, bundles)],
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                     time.gmtime()),
        "per_host": per_host,
        "host_skew": skew,
        "note": ("pod counters/sums are exact per-host sums; merged "
                 "histogram percentiles are approximate "
                 "(reconstituted from persisted order statistics)"),
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(base, fh, indent=1)

    # --- pod metrics stream: rebuilt manifest record, the merged
    # registry (pod totals, no host stamp), then every host's
    # span/event/request/dump records with identity stamped
    n_stream = 0
    host_frames = [[r for r in b["records"]
                    if r.get("kind") == "frame"] for b in bundles]
    pod_frames = fold_timelines(host_frames)
    with EventSink(os.path.join(out_dir, "metrics.jsonl")) as sink:
        sink.emit("manifest", payload=base)
        for rec in merged.records():
            sink.emit(**rec)
        for (idx, host), b in zip(idents, bundles):
            for rec in b["records"]:
                if rec.get("kind") not in _STREAM_KINDS:
                    continue
                fields = {k: v for k, v in rec.items()
                          if k not in _ENVELOPE}
                fields.setdefault("process_index", idx)
                fields.setdefault("host", host)
                sink.emit(rec["kind"], **fields)
                n_stream += 1
        # the folded pod timeline on one clock, stamped
        # host="pod" so replay can tell the fold from the per-host
        # frames re-emitted above
        for fr in pod_frames:
            sink.emit("frame", host="pod", **fr)

    # --- pod trace: remap pids per host so tracks never interleave
    events: List[dict] = []
    next_pid = 1
    for (idx, host), b in zip(idents, bundles):
        pid_map: Dict[int, int] = {}
        for e in b["trace_events"]:
            pid = e.get("pid")
            if pid not in pid_map:
                pid_map[pid] = next_pid
                events.append({"ph": "M", "pid": next_pid,
                               "name": "process_name",
                               "args": {"name": f"host {idx} ({host})"
                                                f" pid {pid}"}})
                next_pid += 1
            events.append({**e, "pid": pid_map[pid]})
    with open(os.path.join(out_dir, "trace.json"), "w") as fh:
        json.dump({"displayTimeUnit": "ms", "traceEvents": events}, fh)

    # --- flight dumps ride along under host-prefixed names
    n_flights = 0
    for (idx, _), b in zip(idents, bundles):
        for f in b["flights"]:
            shutil.copyfile(f, os.path.join(
                out_dir, f"flight_h{idx}_{os.path.basename(f)[7:]}"))
            n_flights += 1

    # --- the acceptance property, re-verified from the merged object
    # (not assumed): every pod counter equals the sum of its per-host
    # values
    snap = merged.snapshot()
    checked = mismatched = 0
    for key, total in snap["counters"].items():
        per = sum(reg.snapshot()["counters"].get(key, 0.0)
                  for reg in regs)
        checked += 1
        if abs(per - total) > 1e-9 * max(1.0, abs(total)):
            mismatched += 1

    # the same exactness property for the folded pod timeline —
    # every pod-frame rate series equals the sum of its per-host
    # values at that seq (re-verified from the emitted fold, not
    # assumed from its construction)
    frames_by_seq = [
        {f.get("seq"): f for f in frames} for frames in host_frames]
    rate_checked = rate_mismatched = 0
    for fr in pod_frames:
        for key, total in fr["series"].items():
            if not key.startswith("rate:"):
                continue
            per = sum(float((hf.get(fr["seq"]) or {})
                            .get("series", {}).get(key, 0.0))
                      for hf in frames_by_seq)
            rate_checked += 1
            if abs(per - total) > 1e-9 * max(1.0, abs(total)):
                rate_mismatched += 1
    return {
        "ok": mismatched == 0 and rate_mismatched == 0,
        "out": out_dir,
        "hosts": len(bundles),
        "merged_counters": len(snap["counters"]),
        "merged_gauges": len(snap["gauges"]),
        "merged_histograms": len(snap["histograms"]),
        "stream_records": n_stream,
        "trace_events": len(events),
        "flight_dumps": n_flights,
        "counter_totals": {"checked": checked,
                           "mismatched": mismatched},
        "timeline": {"pod_frames": len(pod_frames),
                     "per_host_frames": [len(f) for f in host_frames],
                     "rate_sums": {"checked": rate_checked,
                                   "mismatched": rate_mismatched}},
        "host_skew": skew,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m replication_of_minute_frequency_factor_tpu_torch"
             ".telemetry.aggregate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dirs", nargs="+",
                    help="per-host telemetry bundle directories")
    ap.add_argument("--out", required=True,
                    help="pod bundle output directory")
    args = ap.parse_args(argv)
    try:
        verdict = aggregate_dirs(args.dirs, args.out)
    except AggregateError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 2
    # the emitted pod bundle must itself pass the schema — aggregation
    # that produces an invalid bundle is a failure, not a warning
    from .validate import validate_dir
    report = validate_dir(args.out)
    verdict["validate"] = {"ok": report["ok"],
                           "problems": report["problems"][:5]}
    verdict["ok"] = verdict["ok"] and report["ok"]
    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
