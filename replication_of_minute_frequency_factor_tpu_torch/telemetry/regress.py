"""Bench-series regression gate (the port's copy of the JAX package's
``telemetry/regress.py``; standard library only, so it imports nothing of
that package).

``python -m replication_of_minute_frequency_factor_tpu_torch.telemetry.regress
ROOT`` parses the banked ``BENCH_r*.json`` trajectory under ``ROOT``
(the round-end bench records committed at the repo root), builds
per-metric baselines, and flags deviations with a stage-level diff of
where the time moved. The verdict prints as ONE machine-readable JSON
line so harnesses (``chip_smoke.py`` phase 18, a bench session's
end-of-session gate) can embed it.

Series semantics (series breaks are DECLARED, not smeared):

* records group by ``(metric, methodology)``. A record carrying a new
  ``methodology`` value starts a fresh series — one record alone has no
  baseline and is never flagged, so a declared break stays quiet by
  construction.
* records predating the ``methodology`` field (r01–r04) are all the
  double-buffered stream loop (bench.py's own series history), so they
  join the declared ``r4_stream_v2`` series rather than forming a
  phantom "undeclared" one. This is the ONE inference the gate makes,
  and it is pinned here so it cannot drift.
* the declared series names (``r4_stream_v2`` through
  ``r15_serve_edge_v1`` / ``r15_fleet_edge_v1``, and the
  ``+transport=legacy`` A/B leg) are stamped by ``bench.py``; this
  module only keys on them.

Records that the H100 port produces must declare their own
``methodology``, so they start their own series: a card's record never
joins (or gates against) a series banked on another device, in either
direction. That is a rule for whoever writes the records, not a knob
here — nothing in this module knows which device a record came from.

Session sub-series: every bench record stamps the market ``session`` it
ran; records predating the field are all 240-slot cn_ashare runs and
stay on their bare series. A non-default session (``us_390``,
``crypto_1440``, ...) suffixes the effective methodology with
``+session=<name>``, so its records form their own groups and a
non-240 number never smears into a 240 baseline in either direction.

Derived sub-series (:func:`derive_records`) join the trajectory as their
own gateable groups under the parent's methodology, each under its own
availability rule, and flag in BOTH deviation directions:

* ``<metric>.request_p99_ms`` — the record's ``p99_ms``;
* ``<metric>.hbm_peak_bytes`` — ``hbm.peak_bytes``, only when
  ``hbm.available`` is true (a live-arrays estimate never seeds or gates
  a measured watermark);
* ``<metric>.wire_bytes_per_day`` / ``<metric>.result_bytes_per_day`` —
  the per-day bytes each way (growth is a transfer regression, a silent
  drop a lost payload);
* ``<metric>.shard_skew_ratio`` / ``<metric>.pad_waste_frac`` — only when
  ``mesh.available`` is true (real shard watermarks were sampled), and
  ``<metric>.skew_<axis>`` per axis of a 2-D record's ``mesh.axes``
  with real per-axis watermarks;
* ``<metric>.widen_rate`` (with observed result-wire slices) and
  ``<metric>.coverage_frac`` — only when ``factor_health.available``;
* ``<metric>.candidates_per_s`` — only from a discovery loop that ran
  warm (``generations > 0``, ``compiles_during_loop == 0``) inside one
  sync a generation;
* ``<metric>.burn_rate_max`` — only when ``slo.available`` with a
  nonzero frame count;
* ``<metric>.snapshot_p99_flat_ratio`` — only when the per-bar snapshot
  profile is available (warm, enough bars to quartile);
* ``<metric>.wire_bytes_per_answer`` — only when ``edge.available`` with
  wire answers decoded.

Baseline = median of every record in the group EXCEPT the latest; the
latest is the record under test. ``--check FILE`` instead gates a fresh
candidate record against the baseline of the FULL banked group (the
bench-harness mode: "is the record I just measured a regression?").
``--telemetry PATH`` folds the ``span_seconds{span=...}`` histograms of
the ``metrics.jsonl`` streams at or under PATH (the port writes them
through ``telemetry/spans.py`` and ``sink.py``) into the verdict as a
cross-check; it never flags.

Exit codes: 0 = report emitted (deviations, if any, are *reported* —
the committed trajectory is history, not a failure of this checkout);
with ``--strict`` or ``--check``, 1 = a flagged regression; 2 = no
usable input.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

#: deviation (fraction of baseline) past which a record is flagged
DEFAULT_TOLERANCE = 0.05

#: methodology assigned to pre-r5 records that predate the field (every
#: one of them ran bench.py's stream loop; see module docstring)
LEGACY_METHODOLOGY = "r4_stream_v2"

#: stage keys are seconds unless suffixed otherwise
_NON_SECONDS = ("_ms", "_MB")


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------


def _extract_record(doc) -> Optional[dict]:
    """The bench record inside one BENCH_r*.json document.

    Banked files are driver wrappers ``{"n": .., "parsed": {record}}``;
    bare record files (a harness checking its own fresh output) are
    accepted too. The nested ``stale_tpu_headline`` carry is NOT a
    record of the run that banked it — it never becomes a data point.
    """
    if not isinstance(doc, dict):
        return None
    if isinstance(doc.get("parsed"), dict) and "metric" in doc["parsed"]:
        return doc["parsed"]
    if "metric" in doc and "value" in doc:
        return doc
    # last resort: the wrapper's tail holds the printed JSON line
    tail = doc.get("tail")
    if isinstance(tail, str):
        for line in reversed(tail.strip().splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "metric" in rec:
                    return rec
    return None


def load_bench_series(root: str) -> List[dict]:
    """``[{n, source, record}, ...]`` from ``ROOT/BENCH_r*.json``
    (top-level only — fixtures and telemetry dirs below ROOT are not
    part of the banked trajectory), ordered by round number."""
    entries: List[dict] = []
    for path in glob.glob(os.path.join(root, "BENCH_r*.json")):
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        rec = _extract_record(doc)
        if rec is None:
            continue
        m = re.search(r"BENCH_r(\d+)", os.path.basename(path))
        n = doc.get("n") if isinstance(doc, dict) else None
        if not isinstance(n, int):
            n = int(m.group(1)) if m else 0
        entries.append({"n": n, "source": os.path.basename(path),
                        "record": rec})
        # derived sub-series join the trajectory as their own
        # (metric, methodology) groups — same banked file, own baseline
        for drec in derive_records(rec):
            entries.append({
                "n": n,
                "source": (os.path.basename(path) + "#"
                           + drec["derived_from"]),
                "record": drec})
    entries.sort(key=lambda e: (e["n"], e["source"]))
    return entries


def load_telemetry_spans(paths: List[str]) -> dict:
    """Fold ``span_seconds{span=...}`` histogram records out of
    telemetry ``metrics.jsonl`` streams into per-span stats — the
    cross-check between the bench series' ``stages`` dicts and what the
    instrumented run itself recorded."""
    spans: Dict[str, dict] = {}
    files = 0
    for path in paths:
        try:
            with open(path) as fh:
                lines = fh.readlines()
        except OSError:
            continue
        files += 1
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if (rec.get("kind") == "histogram"
                    and rec.get("name") == "span_seconds"):
                span = (rec.get("labels") or {}).get("span")
                if span:
                    spans[span] = {"count": rec.get("count"),
                                   "sum_s": rec.get("sum"),
                                   "p50_s": rec.get("p50"),
                                   "p95_s": rec.get("p95")}
    return {"files": files, "spans": spans}


def find_metrics_jsonl(path: str, max_depth: int = 3) -> List[str]:
    """metrics.jsonl files at or under ``path`` (bounded depth)."""
    if os.path.isfile(path):
        return [path]
    out: List[str] = []
    base_depth = path.rstrip(os.sep).count(os.sep)
    for r, dirs, fs in os.walk(path):
        if r.count(os.sep) - base_depth >= max_depth:
            dirs[:] = []
        if "metrics.jsonl" in fs:
            out.append(os.path.join(r, "metrics.jsonl"))
    return sorted(out)


# --------------------------------------------------------------------------
# baselines + evaluation
# --------------------------------------------------------------------------


#: the canonical market session. Records without a
#: ``session`` stamp — the whole banked trajectory predating the field
#: — are all 240-day cn_ashare runs, so they stay on their bare
#: methodology series; this is the same one pinned inference as
#: LEGACY_METHODOLOGY above.
DEFAULT_SESSION = "cn_ashare_240"


def effective_methodology(record: dict) -> str:
    m = record.get("methodology")
    meth = str(m) if m else LEGACY_METHODOLOGY
    # session sub-series keying: a non-default session is a
    # DIFFERENT workload shape — 390 or 1440 slots change the module,
    # the bytes and the loop — so its records suffix the methodology
    # and start their own baseline. A us_390 record can never pollute
    # (or be gated against) the banked 240 series, in either
    # direction; derived sub-series inherit the suffixed methodology
    # like every other declared break.
    session = record.get("session")
    if session and str(session) != DEFAULT_SESSION \
            and "+session=" not in meth:
        meth = f"{meth}+session={session}"
    return meth


def derive_records(record: dict) -> List[dict]:
    """Gateable sub-series lifted out of one bench record:

    * ``<metric>.request_p99_ms`` — the record's ``p99_ms`` (the
      serve/stream end-to-end request-latency distribution's tail; a
      QPS headline that holds while p99 doubles is a regression the
      top-line ``value`` cannot see);
    * ``<metric>.hbm_peak_bytes`` — the record's ``hbm.peak_bytes``
      watermark, ONLY when ``hbm.available`` is true (a live-arrays
      estimate from a CPU fallback must never gate against — or seed —
      a measured HBM baseline).

    Derived records inherit the parent's methodology, so they ride the
    existing per-(metric, methodology) machinery unchanged: the first
    record of a new series is a declared break (reported, not
    flagged), later ones gate at the same tolerance.
    """
    out: List[dict] = []
    metric = record.get("metric")
    if not isinstance(metric, str) or not metric:
        return out
    meth = effective_methodology(record)
    p99 = record.get("p99_ms")
    if isinstance(p99, (int, float)) and not isinstance(p99, bool):
        out.append({"metric": f"{metric}.request_p99_ms",
                    "value": float(p99), "unit": "ms",
                    "methodology": meth,
                    "derived_from": "p99_ms",
                    "stages": record.get("stages")})
    hbm = record.get("hbm")
    if isinstance(hbm, dict) and hbm.get("available"):
        peak = hbm.get("peak_bytes")
        if isinstance(peak, (int, float)) and not isinstance(peak, bool) \
                and peak > 0:
            out.append({"metric": f"{metric}.hbm_peak_bytes",
                        "value": float(peak), "unit": "bytes",
                        "methodology": meth,
                        "derived_from": "hbm.peak_bytes"})
    # byte-program sub-series: the per-day bytes each way.
    # Either sign of deviation flags via the shared tolerance machinery
    # (growth = transfer regression; silent shrink = lost payload)
    for block_key, metric_suffix in (("wire", "wire_bytes_per_day"),
                                     ("result", "result_bytes_per_day")):
        block = record.get(block_key)
        if isinstance(block, dict):
            bpd = block.get("bytes_per_day")
            if isinstance(bpd, (int, float)) \
                    and not isinstance(bpd, bool) and bpd > 0:
                out.append({"metric": f"{metric}.{metric_suffix}",
                            "value": float(bpd), "unit": "bytes/day",
                            "methodology": meth,
                            "derived_from":
                                f"{block_key}.bytes_per_day"})
    # factor-health sub-series: gated on
    # factor_health.available — only records whose dispatches actually
    # carried the fused stats side-output seed or gate these.
    # widen_rate additionally requires observed result-wire slices
    # (None when the wire was off — a wire-less record must not gate a
    # widen baseline at 0). Both directions flag: a widen-rate JUMP
    # means slices stopped fitting their pinned bounds (the
    # log-transform question), a silent DROP to ~0 usually means the
    # per-factor attribution went dark; a coverage DROP is missing
    # data, a jump means the mask/universe changed shape.
    fh = record.get("factor_health")
    if isinstance(fh, dict) and fh.get("available"):
        wr = fh.get("widen_rate")
        if isinstance(wr, (int, float)) and not isinstance(wr, bool) \
                and (fh.get("widen") or {}).get("slices"):
            out.append({"metric": f"{metric}.widen_rate",
                        "value": float(wr), "unit": "frac",
                        "methodology": meth,
                        "derived_from": "factor_health.widen_rate"})
        cov = fh.get("coverage_frac")
        if isinstance(cov, (int, float)) and not isinstance(cov, bool) \
                and cov > 0:
            out.append({"metric": f"{metric}.coverage_frac",
                        "value": float(cov), "unit": "frac",
                        "methodology": meth,
                        "derived_from":
                            "factor_health.coverage_frac"})
    # discovery sub-series: gated on the discover block's
    # own evidence — only loops that completed generations WARM
    # (zero loop compiles) and inside the 1-sync/generation budget
    # seed or gate the candidates/sec baseline (a cold loop measures
    # the compiler, a chatty one measures the host round trip)
    disc = record.get("discover")
    if isinstance(disc, dict) \
            and isinstance(disc.get("generations"), int) \
            and disc["generations"] > 0 \
            and disc.get("compiles_during_loop") == 0 \
            and isinstance(disc.get("syncs_per_generation"),
                           (int, float)) \
            and not isinstance(disc.get("syncs_per_generation"), bool) \
            and disc["syncs_per_generation"] <= 1:
        cps = disc.get("candidates_per_s")
        if isinstance(cps, (int, float)) and not isinstance(cps, bool) \
                and cps > 0:
            out.append({"metric": f"{metric}.candidates_per_s",
                        "value": float(cps), "unit": "candidates/s",
                        "methodology": meth,
                        "derived_from": "discover.candidates_per_s"})
    # mesh balance sub-series: gated on mesh.available — only
    # records with REAL shard watermarks (telemetry/meshplane.py) seed
    # or gate the balance baselines
    mesh = record.get("mesh")
    if isinstance(mesh, dict) and mesh.get("available"):
        skew = mesh.get("shard_skew_ratio")
        if isinstance(skew, (int, float)) and not isinstance(skew, bool) \
                and skew > 0:
            out.append({"metric": f"{metric}.shard_skew_ratio",
                        "value": float(skew), "unit": "ratio",
                        "methodology": meth,
                        "derived_from": "mesh.shard_skew_ratio"})
        waste = mesh.get("pad_waste_frac")
        if isinstance(waste, (int, float)) \
                and not isinstance(waste, bool) and waste >= 0:
            out.append({"metric": f"{metric}.pad_waste_frac",
                        "value": float(waste), "unit": "frac",
                        "methodology": meth,
                        "derived_from": "mesh.pad_waste_frac"})
        # per-axis skew sub-series from 2-D records: only
        # axes with REAL per-axis watermarks qualify — 1-D records
        # carry no ``axes`` block and derive nothing here
        axes = mesh.get("axes")
        if isinstance(axes, dict):
            for axis, info in sorted(axes.items()):
                if not isinstance(info, dict):
                    continue
                askew = info.get("skew_ratio")
                if isinstance(askew, (int, float)) \
                        and not isinstance(askew, bool) and askew > 0 \
                        and info.get("shard_time_s"):
                    out.append({"metric": f"{metric}.skew_{axis}",
                                "value": float(askew), "unit": "ratio",
                                "methodology": meth,
                                "derived_from":
                                    f"mesh.axes.{axis}.skew_ratio"})
    # SLO burn sub-series: gated on slo.available with a
    # nonzero timeline (a record whose sampler never ran measured
    # nothing — it must not seed or gate a burn baseline at 0). Both
    # directions flag through the shared tolerance machinery: a burn
    # JUMP means the run spent error budget it never spent before
    # (sheds, tail latency, stale ingest), a silent DROP to ~0 on a
    # series that used to burn usually means the objective's signal
    # went dark, not that the service got perfect.
    slo = record.get("slo")
    if isinstance(slo, dict) and slo.get("available") \
            and isinstance(slo.get("frames"), int) and slo["frames"] > 0:
        wbr = slo.get("worst_burn_rate")
        if isinstance(wbr, (int, float)) and not isinstance(wbr, bool) \
                and wbr >= 0:
            out.append({"metric": f"{metric}.burn_rate_max",
                        "value": float(wbr), "unit": "ratio",
                        "methodology": meth,
                        "derived_from": "slo.worst_burn_rate"})
    # binary-edge sub-series: gated on edge.available with
    # answers actually decoded — only an HTTP wire load that counted
    # its bytes at the CLIENT seeds or gates the per-answer baseline.
    # Both directions flag: byte GROWTH per answer is a wire
    # regression (framing bloat, a lost quantization tier), a silent
    # DROP usually means the answers lost content (a shrunken factor
    # set shipping under the same metric name) — neither may pass
    # quietly.
    edge = record.get("edge")
    if isinstance(edge, dict) and edge.get("available") \
            and isinstance(edge.get("wire_answers"), int) \
            and edge["wire_answers"] > 0:
        wbpa = edge.get("wire_bytes_per_answer")
        if isinstance(wbpa, (int, float)) and not isinstance(wbpa, bool) \
                and wbpa > 0:
            out.append({"metric": f"{metric}.wire_bytes_per_answer",
                        "value": float(wbpa), "unit": "bytes/answer",
                        "methodology": meth,
                        "derived_from":
                            "edge.wire_bytes_per_answer"})
    # snapshot-flatness sub-series: gated on the per-bar
    # profile's own evidence — only a WARM profile (zero compiles
    # while profiling, enough bars to quartile) measures finalize
    # flatness; a cold one measures the compiler and must not seed the
    # baseline. Both directions flag: a ratio JUMP on the fast series
    # means per-snapshot work regrew a bar-cursor dependence, a
    # silent DROP toward 0 means the profile stopped measuring the
    # finalize at all.
    snap = record.get("snapshot")
    if isinstance(snap, dict) and snap.get("available"):
        flat = snap.get("p99_flat_ratio")
        if isinstance(flat, (int, float)) and not isinstance(flat, bool) \
                and flat > 0:
            out.append({"metric": f"{metric}.snapshot_p99_flat_ratio",
                        "value": float(flat), "unit": "ratio",
                        "methodology": meth,
                        "derived_from": "snapshot.p99_flat_ratio"})
    return out


def group_entries(entries: List[dict]) -> Dict[Tuple[str, str], List[dict]]:
    groups: Dict[Tuple[str, str], List[dict]] = {}
    for e in entries:
        rec = e["record"]
        key = (str(rec.get("metric")), effective_methodology(rec))
        groups.setdefault(key, []).append(e)
    return groups


def _stages_seconds(record: dict) -> Dict[str, float]:
    out = {}
    for k, v in (record.get("stages") or {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and not any(k.endswith(s) for s in _NON_SECONDS):
            out[k] = float(v)
    return out


def stage_diff(baseline_entries: List[dict], latest: dict) -> List[dict]:
    """Where the time moved: latest record's per-stage seconds vs the
    per-stage median over the baseline entries, sorted by |delta|
    descending. Stages present on only one side report a null for the
    missing side (a stage appearing/disappearing IS a finding)."""
    base: Dict[str, List[float]] = {}
    for e in baseline_entries:
        for k, v in _stages_seconds(e["record"]).items():
            base.setdefault(k, []).append(v)
    base_med = {k: _median(v) for k, v in base.items()}
    latest_st = _stages_seconds(latest)
    rows = []
    for k in sorted(set(base_med) | set(latest_st)):
        b = base_med.get(k)
        l_ = latest_st.get(k)
        row = {"stage": k,
               "baseline_s": round(b, 3) if b is not None else None,
               "latest_s": round(l_, 3) if l_ is not None else None}
        if b is not None and l_ is not None:
            row["delta_s"] = round(l_ - b, 3)
            row["delta_pct"] = (round(100.0 * (l_ - b) / b, 1)
                                if b else None)
        rows.append(row)
    rows.sort(key=lambda r: abs(r.get("delta_s") or 0.0), reverse=True)
    return rows


def _evaluate_group(key: Tuple[str, str], entries: List[dict],
                    candidate: Optional[dict],
                    tolerance: float) -> Optional[dict]:
    """Verdict row for one (metric, methodology) series. With a
    ``candidate`` record, the whole banked group is the baseline;
    otherwise the group's latest entry is under test. None when there
    is nothing to compare against (a declared break's first record)."""
    if candidate is not None:
        baseline_entries = entries
        latest_rec = candidate
        latest_src = "candidate"
    else:
        if len(entries) < 2:
            return None
        baseline_entries = entries[:-1]
        latest_rec = entries[-1]["record"]
        latest_src = entries[-1]["source"]
    vals = [e["record"].get("value") for e in baseline_entries]
    vals = [float(v) for v in vals
            if isinstance(v, (int, float)) and not isinstance(v, bool)]
    latest_val = latest_rec.get("value")
    if not vals or not isinstance(latest_val, (int, float)):
        return None
    baseline = _median(vals)
    deviation = ((float(latest_val) - baseline) / baseline
                 if baseline else 0.0)
    flagged = abs(deviation) > tolerance
    row = {
        "metric": key[0],
        "methodology": key[1],
        "n_baseline": len(vals),
        "baseline_value": round(baseline, 3),
        "baseline_band": [round(min(vals), 3), round(max(vals), 3)],
        "latest_value": round(float(latest_val), 3),
        "latest_source": latest_src,
        "deviation_pct": round(100.0 * deviation, 2),
        "flagged": flagged,
    }
    if flagged:
        row["stage_diff"] = stage_diff(baseline_entries, latest_rec)
    return row


def evaluate(entries: List[dict], tolerance: float = DEFAULT_TOLERANCE,
             candidate: Optional[dict] = None) -> dict:
    """The machine-readable verdict over a loaded trajectory (and an
    optional fresh candidate record)."""
    groups = group_entries(entries)
    rows: List[dict] = []
    if candidate is not None:
        # the candidate gates as itself AND as each derived sub-series:
        # a steady headline with a doubled request p99 or
        # HBM watermark flags on the derived group
        for cand in [candidate] + derive_records(candidate):
            key = (str(cand.get("metric")),
                   effective_methodology(cand))
            row = _evaluate_group(key, groups.get(key, []), cand,
                                  tolerance)
            if row is None:
                # no banked series for this (metric, methodology): a
                # declared break — reported, never flagged
                rows.append({"metric": key[0], "methodology": key[1],
                             "n_baseline": 0, "flagged": False,
                             "note": "no baseline series (declared "
                                     "break or first record)"})
            else:
                rows.append(row)
    else:
        for key in sorted(groups):
            row = _evaluate_group(key, groups[key], None, tolerance)
            if row is not None:
                rows.append(row)
    flagged = [r for r in rows if r.get("flagged")]
    return {
        "schema": 1,
        "tolerance_pct": round(100.0 * tolerance, 2),
        "records": sum(len(v) for v in groups.values()),
        "series": len(groups),
        "groups": rows,
        "flagged": [{"metric": r["metric"],
                     "methodology": r["methodology"],
                     "deviation_pct": r["deviation_pct"]}
                    for r in flagged],
        "ok": not flagged,
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m replication_of_minute_frequency_factor_tpu_torch"
             ".telemetry.regress",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", help="directory holding the BENCH_r*.json "
                                 "trajectory (the repo root)")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="flag |deviation| past this fraction of the "
                         "baseline (default 0.05)")
    ap.add_argument("--check", metavar="FILE", default=None,
                    help="gate a fresh candidate record (bare record "
                         "JSON or driver wrapper) against the banked "
                         "baselines; exits 1 when flagged")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when the trajectory's own latest "
                         "record in any series is flagged")
    ap.add_argument("--telemetry", metavar="PATH", default=None,
                    help="also fold span_seconds stats out of "
                         "metrics.jsonl streams at/under PATH into the "
                         "verdict (cross-check, never flags)")
    ap.add_argument("--out", metavar="FILE", default=None,
                    help="additionally write the verdict (indented) "
                         "to FILE")
    args = ap.parse_args(argv)

    entries = load_bench_series(args.root)
    candidate = None
    if args.check:
        try:
            with open(args.check) as fh:
                candidate = _extract_record(json.load(fh))
        except (OSError, ValueError) as e:
            print(json.dumps({"ok": False,
                              "error": f"unreadable --check file: {e}"}))
            return 2
        if candidate is None:
            print(json.dumps({"ok": False,
                              "error": "--check file holds no bench "
                                       "record"}))
            return 2
    if not entries and candidate is None:
        print(json.dumps({"ok": False,
                          "error": f"no BENCH_r*.json under "
                                   f"{args.root!r}"}))
        return 2

    verdict = evaluate(entries, tolerance=args.tolerance,
                       candidate=candidate)
    if args.telemetry:
        verdict["telemetry"] = load_telemetry_spans(
            find_metrics_jsonl(args.telemetry))
    # ONE line on stdout: harnesses parse it as a JSON line
    print(json.dumps(verdict))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(verdict, fh, indent=1)
    if (args.strict or candidate is not None) and not verdict["ok"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
