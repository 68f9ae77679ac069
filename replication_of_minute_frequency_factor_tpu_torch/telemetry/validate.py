"""Validate a written telemetry directory (or flight dump) against the
schema.

    python -m replication_of_minute_frequency_factor_tpu_torch.telemetry.validate DIR
    python -m ...telemetry.validate flight_123_001_breaker_trip.jsonl

Directory mode checks the artifacts ``Telemetry.write`` produces:

* ``manifest.json`` — parseable, a supported schema version, config hash;
* ``metrics.jsonl`` — EVERY line validates via :func:`..sink.validate_record`;
* ``trace.json`` — parseable Chrome trace with a ``traceEvents`` list;
* every ``flight_*.jsonl`` — flight-recorder dumps: each
  must lead with a ``dump`` header record and every line must validate.

File mode (a ``.jsonl`` path) validates one flight dump standalone —
the check the breaker-trip acceptance gate and the ops-plane smoke run
on a freshly captured dump.

Prints a one-line JSON report and exits non-zero on any problem. The
port's copy of the JAX package's validator; both accept the port's
bundles.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import List, Optional

from .sink import SCHEMA_VERSION, validate_jsonl

#: manifest schema versions this validator accepts (old bundles stay
#: checkable; the envelope validator enforces per-record versioning)
ACCEPTED_SCHEMAS = tuple(range(1, SCHEMA_VERSION + 1))


def validate_dump(path: str) -> dict:
    """Validate one flight-recorder dump file: every line schema-valid,
    at least one record, and a ``dump`` header record present."""
    problems: List[str] = []
    kinds: dict = {}
    n_lines = 0
    try:
        for lineno, line_problems in validate_jsonl(path):
            n_lines += 1
            for p in line_problems:
                problems.append(f"{os.path.basename(path)}:{lineno}: {p}")
    except OSError as e:
        problems.append(f"{path}: {e}")
    if not problems:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    k = json.loads(line).get("kind")
                except json.JSONDecodeError:
                    continue
                kinds[k] = kinds.get(k, 0) + 1
        if n_lines == 0:
            problems.append(f"{os.path.basename(path)} is empty")
        elif not kinds.get("dump"):
            problems.append(f"{os.path.basename(path)} has no 'dump' "
                            "header record")
    return {"ok": not problems, "path": path, "jsonl_lines": n_lines,
            "kinds": kinds, "problems": problems}


def validate_dir(out_dir: str) -> dict:
    """Report dict: ``{"ok": bool, "problems": [...], ...counts}``."""
    problems: List[str] = []
    kinds: dict = {}

    mpath = os.path.join(out_dir, "manifest.json")
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
        if manifest.get("schema") not in ACCEPTED_SCHEMAS:
            problems.append(f"manifest schema={manifest.get('schema')!r}")
        if not isinstance(manifest.get("config_hash"), str) \
                or len(manifest["config_hash"]) != 64:
            problems.append("manifest config_hash missing/malformed")
    except (OSError, json.JSONDecodeError) as e:
        problems.append(f"manifest.json: {e}")

    jpath = os.path.join(out_dir, "metrics.jsonl")
    n_lines = 0
    try:
        for lineno, line_problems in validate_jsonl(jpath):
            n_lines += 1
            for p in line_problems:
                problems.append(f"metrics.jsonl:{lineno}: {p}")
        if n_lines == 0:
            problems.append("metrics.jsonl is empty")
        else:
            with open(jpath) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        k = json.loads(line).get("kind")
                    except json.JSONDecodeError:
                        continue
                    kinds[k] = kinds.get(k, 0) + 1
    except OSError as e:
        problems.append(f"metrics.jsonl: {e}")

    tpath = os.path.join(out_dir, "trace.json")
    try:
        with open(tpath) as fh:
            trace = json.load(fh)
        if not isinstance(trace.get("traceEvents"), list):
            problems.append("trace.json has no traceEvents list")
    except (OSError, json.JSONDecodeError) as e:
        problems.append(f"trace.json: {e}")

    flights = sorted(glob.glob(os.path.join(out_dir, "flight_*.jsonl")))
    for fpath in flights:
        report = validate_dump(fpath)
        problems.extend(report["problems"])

    return {"ok": not problems, "dir": out_dir, "jsonl_lines": n_lines,
            "kinds": kinds, "flight_dumps": len(flights),
            "problems": problems}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 1:
        print("usage: python -m replication_of_minute_frequency_factor_tpu_torch"
              ".telemetry.validate DIR|DUMP.jsonl", file=sys.stderr)
        return 2
    target = argv[0]
    if os.path.isfile(target):
        report = validate_dump(target)
    else:
        report = validate_dir(target)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
