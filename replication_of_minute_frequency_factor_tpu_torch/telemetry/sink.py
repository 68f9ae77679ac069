"""Schema-versioned JSONL event sink + record validation.

Every line a run emits is one JSON object carrying ``schema`` (the
integer schema version), ``ts`` (unix seconds) and ``kind``; the
remaining fields are kind-specific. The validator below IS the schema —
`run_tests.sh`'s telemetry smoke check and the unit suite both validate
emitted streams through it, so producers and the schema cannot drift
apart silently. Bump ``SCHEMA_VERSION`` on any breaking field change.

Version history:

* **v1** — manifest / counter / gauge / histogram / span / event.
* **v2** (the live ops plane) — adds the ``request`` kind
  (one serving request's full lifecycle, keyed by ``trace_id``) and
  the ``dump`` kind (a flight-recorder dump header), and allows an
  optional ``trace_id`` on ``span`` records. v1 records remain valid:
  the validator accepts any schema in ``[1, SCHEMA_VERSION]`` and
  rejects v2-only kinds/fields on records that declare ``schema: 1``,
  so both directions are checkable (regression-tested in
  tests/test_opsplane.py).
* **v3** (the mesh observability plane) — every kind may
  carry ``process_index`` (int) and ``host`` (str), the multihost
  identity stamps ``Telemetry.write`` applies so
  ``telemetry.aggregate`` can merge per-host bundles into one pod
  bundle without guessing provenance; ``span`` records may carry
  ``labels`` (the span's label dict, e.g. ``kind=host_dispatch`` on
  the collective dispatch spans). Same both-direction contract: a
  record declaring ``schema <= 2`` that carries any of these FLAGS
  (regression-tested in tests/test_meshplane.py).
* **v4** (the SLO plane) — adds the ``frame`` kind (one
  timeline sample: ``seq`` monotone per-process frame index,
  ``interval_s`` the measured sampling interval, ``series`` the
  name->value dict of counter rates / gauge values / histogram
  quantiles — telemetry/timeline.py) and the ``slo`` kind (one SLO
  plane event — an alert transition or end-of-run objective verdict,
  ``name`` the objective, ``data`` the payload — telemetry/slo.py).
  Same both-direction contract: a record declaring ``schema <= 3``
  that carries either kind FLAGS (regression-tested in
  tests/test_slo.py).
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, Iterator, List, Optional, Tuple

SCHEMA_VERSION = 4

#: kind -> required fields beyond the envelope (field, allowed types).
#: histogram stat fields admit None (an empty histogram has no min/max).
_NUM = (int, float)
KIND_FIELDS = {
    "manifest": (("payload", (dict,)),),
    "counter": (("name", (str,)), ("labels", (dict,)), ("value", _NUM)),
    "gauge": (("name", (str,)), ("labels", (dict,)), ("value", _NUM)),
    "histogram": (("name", (str,)), ("labels", (dict,)),
                  ("count", (int,)), ("sum", _NUM),
                  ("min", _NUM + (type(None),)),
                  ("max", _NUM + (type(None),)),
                  ("p50", _NUM + (type(None),)),
                  ("p95", _NUM + (type(None),))),
    "span": (("name", (str,)), ("ts_us", _NUM), ("dur_us", _NUM),
             ("tid", (int,)), ("depth", (int,))),
    "event": (("name", (str,)), ("data", (dict,))),
    # v2: one request's lifecycle (``op`` is the query kind — the
    # envelope's ``kind`` field names the record kind) and the
    # flight-recorder dump header (telemetry/opsplane.py)
    "request": (("trace_id", (str,)), ("op", (str,)),
                ("status", (str,)), ("data", (dict,))),
    "dump": (("trigger", (str,)), ("data", (dict,))),
    # v4: one timeline frame (telemetry/timeline.py — counter rates,
    # gauge values and histogram quantiles sampled on one clock) and
    # one SLO plane event (telemetry/slo.py — an alert transition or
    # the end-of-run objective verdict)
    "frame": (("seq", (int,)), ("interval_s", _NUM),
              ("series", (dict,))),
    "slo": (("name", (str,)), ("data", (dict,))),
}

#: kinds that did not exist before schema v2 — a record declaring
#: ``schema: 1`` must not carry them
V2_ONLY_KINDS = frozenset({"request", "dump"})

#: kinds that did not exist before schema v4 — a record
#: declaring ``schema <= 3`` must not carry them
V4_ONLY_KINDS = frozenset({"frame", "slo"})

#: (kind, field) -> (allowed types, minimum schema): optional fields
#: that are type-checked when present and version-gated. Kind ``"*"``
#: applies to every kind — the v3 multihost identity stamps.
OPTIONAL_FIELDS = {
    ("span", "trace_id"): ((str,), 2),
    ("span", "labels"): ((dict,), 3),
    ("*", "process_index"): ((int,), 3),
    ("*", "host"): ((str,), 3),
}


def validate_record(rec) -> List[str]:
    """Problems with one decoded JSONL record; [] means schema-valid.
    Accepts every schema version in ``[1, SCHEMA_VERSION]`` — old
    bundles stay valid; version-gated kinds/fields flag on records
    that declare an older schema."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    problems = []
    schema = rec.get("schema")
    if not isinstance(schema, int) or isinstance(schema, bool) \
            or not (1 <= schema <= SCHEMA_VERSION):
        problems.append(f"schema={schema!r} "
                        f"(expected 1..{SCHEMA_VERSION})")
        schema = SCHEMA_VERSION  # field checks still run
    if not isinstance(rec.get("ts"), _NUM):
        problems.append(f"ts={rec.get('ts')!r} is not a number")
    kind = rec.get("kind")
    if kind not in KIND_FIELDS:
        problems.append(f"kind={kind!r} not one of "
                        f"{sorted(KIND_FIELDS)}")
        return problems
    if kind in V2_ONLY_KINDS and schema < 2:
        problems.append(f"kind={kind!r} needs schema>=2 "
                        f"(record declares {schema})")
    if kind in V4_ONLY_KINDS and schema < 4:
        problems.append(f"kind={kind!r} needs schema>=4 "
                        f"(record declares {schema})")
    for field, types in KIND_FIELDS[kind]:
        v = rec.get(field, _MISSING)
        if v is _MISSING:
            problems.append(f"{kind} record missing {field!r}")
        elif not isinstance(v, types) or isinstance(v, bool):
            problems.append(
                f"{kind}.{field}={v!r} has type {type(v).__name__}")
    for (k, field), (types, min_schema) in OPTIONAL_FIELDS.items():
        if k not in ("*", kind) or field not in rec:
            continue
        v = rec[field]
        if schema < min_schema:
            problems.append(f"{kind}.{field} needs schema"
                            f">={min_schema} (record declares {schema})")
        if not isinstance(v, types) or isinstance(v, bool):
            problems.append(
                f"{kind}.{field}={v!r} has type {type(v).__name__}")
    return problems


class _Missing:
    pass


_MISSING = _Missing()


def validate_jsonl(path: str) -> Iterator[Tuple[int, List[str]]]:
    """Yield ``(lineno, problems)`` per line; empty problems = valid."""
    with open(path) as fh:
        for i, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                yield i, [f"not JSON: {e}"]
                continue
            yield i, validate_record(rec)


class EventSink:
    """Append-only JSONL writer stamping the schema envelope on every
    record; thread-safe, line-buffered (one flush per record so a
    crashed run keeps everything emitted before the crash).

    ``common`` fields (the v3 multihost identity stamps —
    ``process_index``/``host``) land on EVERY emitted record; explicit
    per-record fields win over them, so an aggregator re-emitting a
    foreign host's records keeps their original stamps."""

    def __init__(self, path: str, common: Optional[dict] = None):
        self.path = path
        self._common = dict(common or {})
        self._fh: Optional[IO[str]] = open(path, "a")
        self._lock = threading.Lock()

    def emit(self, kind: str, **fields) -> dict:
        rec = {"schema": SCHEMA_VERSION, "ts": round(time.time(), 3),
               "kind": kind, **self._common, **fields}
        problems = validate_record(rec)
        if problems:
            raise ValueError(f"refusing to emit schema-invalid record: "
                             f"{problems}")
        line = json.dumps(rec)
        with self._lock:
            if self._fh is None:
                raise ValueError(f"sink {self.path} is closed")
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "EventSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
