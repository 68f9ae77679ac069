"""The port's bundle tools, ``telemetry.validate`` and
``telemetry.aggregate`` (copies of the JAX package's on the port's sink
and registry), on the CPU.

A bundle the port writes passes both packages' validators; the port's
aggregate of two port bundles gives the JAX package's aggregate of the
same two (verdict, pod registry, stream, trace tracks), and the pod
bundle passes both validators; each tool's ``python -m`` entry point
prints one JSON verdict and exits as the JAX package's does.
"""

import json
import os
import subprocess
import sys

import pytest

from replication_of_minute_frequency_factor_tpu.telemetry import (
    aggregate as jax_aggregate)
from replication_of_minute_frequency_factor_tpu.telemetry import (
    validate as jax_validate)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    MeshPlane, Telemetry, aggregate, validate)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_bundle(tmp_path, idx, requests, latency, frames=True):
    """tests/test_meshplane.py's host bundle, written by the port."""
    tel = Telemetry(annotate_spans=False)
    tel.counter("pod.requests", requests)
    tel.counter("pod.errors", idx)
    tel.gauge("pod.depth", 10 + idx)
    for v in latency:
        tel.observe("pod.latency_s", v)
    with tel.tracer("pod.step"):
        pass
    tel.request({"trace_id": f"t{idx}", "op": "q", "status": "ok",
                 "data": {"total_s": 0.1}})
    if frames:
        tel.counter("serve.requests", 2 + idx, kind="factors")
        tel.timeline.sample()
        tel.counter("serve.requests", 3, kind="factors")
        tel.timeline.sample()
    d = str(tmp_path / f"host{idx}")
    tel.write(d, process_index=idx, host=f"host{idx}")
    return d


def test_a_port_bundle_passes_both_validators(tmp_path):
    d = _host_bundle(tmp_path, 0, 3, [0.01, 0.02])
    got, want = validate.validate_dir(d), jax_validate.validate_dir(d)
    assert got["ok"] and want["ok"], (got, want)
    assert got == want
    assert got["kinds"]["manifest"] == 1 and got["kinds"]["frame"] == 2


def test_validate_flags_what_the_jax_validator_flags(tmp_path):
    d = _host_bundle(tmp_path, 0, 3, [0.01])
    with open(os.path.join(d, "metrics.jsonl"), "a") as fh:
        fh.write(json.dumps({"schema": 99, "kind": "counter"}) + "\n")
    os.remove(os.path.join(d, "trace.json"))
    got, want = validate.validate_dir(d), jax_validate.validate_dir(d)
    assert not got["ok"] and got == want
    assert validate.validate_dir(str(tmp_path / "nope")) == \
        jax_validate.validate_dir(str(tmp_path / "nope"))


def test_a_flight_dump_validates_alike(tmp_path):
    tel = Telemetry(annotate_spans=False)
    mp = MeshPlane(telemetry=tel, dump_dir=str(tmp_path), skew_threshold=1.5,
                   burst=1)
    dump = mp.record_shard_times({"a": 0.01, "b": 0.9})["burst_dump"]
    assert dump
    assert validate.validate_dump(dump) == jax_validate.validate_dump(dump)
    assert validate.validate_dump(dump)["ok"]


def _without(d: dict, *keys):
    return {k: v for k, v in d.items() if k not in keys}


def _pod_stream(pod):
    """The pod stream's records with the sink's wall-clock stamp out."""
    with open(os.path.join(pod, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    return [_without(r, "ts") if r["kind"] != "manifest"
            else _without(r, "ts", "payload") for r in recs]


def test_aggregate_equals_the_jax_aggregate(tmp_path):
    dirs = [_host_bundle(tmp_path, 0, 3, [0.01, 0.02]),
            _host_bundle(tmp_path, 1, 5, [0.03])]
    pod, jpod = str(tmp_path / "pod"), str(tmp_path / "jpod")
    got = aggregate.aggregate_dirs(dirs, pod)
    want = jax_aggregate.aggregate_dirs(dirs, jpod)
    assert got["ok"] and got["counter_totals"]["mismatched"] == 0
    assert got["timeline"]["rate_sums"]["mismatched"] == 0
    assert got["timeline"]["pod_frames"] == 2
    assert _without(got, "out") == _without(want, "out")
    # the pod registries, reconstituted from each pod bundle
    snap = aggregate.registry_of(aggregate.load_bundle(pod)).snapshot()
    jsnap = jax_aggregate.registry_of(
        jax_aggregate.load_bundle(jpod)).snapshot()
    assert snap == jsnap
    assert snap["counters"]["pod.requests"] == 8
    assert _pod_stream(pod) == _pod_stream(jpod)
    with open(os.path.join(pod, "trace.json")) as fh, \
            open(os.path.join(jpod, "trace.json")) as jfh:
        assert json.load(fh) == json.load(jfh)
    with open(os.path.join(pod, "manifest.json")) as fh, \
            open(os.path.join(jpod, "manifest.json")) as jfh:
        m, jm = json.load(fh), json.load(jfh)
    assert _without(m["aggregate"], "created_utc") == \
        _without(jm["aggregate"], "created_utc")
    for check in (validate.validate_dir, jax_validate.validate_dir):
        assert check(pod)["ok"] and check(jpod)["ok"]


def test_aggregate_refuses_duplicate_process_index(tmp_path):
    d = _host_bundle(tmp_path, 0, 3, [0.01])
    with pytest.raises(aggregate.AggregateError, match="duplicate"):
        aggregate.aggregate_dirs([d, d], str(tmp_path / "pod"))


def test_aggregate_carries_flight_dumps(tmp_path):
    d0 = _host_bundle(tmp_path, 0, 1, [0.01], frames=False)
    d1 = _host_bundle(tmp_path, 1, 1, [0.01], frames=False)
    mp = MeshPlane(telemetry=Telemetry(annotate_spans=False), dump_dir=d1,
                   skew_threshold=1.5, burst=1)
    assert mp.record_shard_times({"a": 0.01, "b": 0.9})["burst_dump"]
    pod = str(tmp_path / "pod")
    verdict = aggregate.aggregate_dirs([d0, d1], pod)
    assert verdict["flight_dumps"] == 1
    assert len([f for f in os.listdir(pod)
                if f.startswith("flight_h1_")]) == 1
    assert validate.validate_dir(pod)["ok"]


def _run(module, *args):
    return subprocess.run(
        [sys.executable, "-m",
         f"replication_of_minute_frequency_factor_tpu_torch.telemetry."
         f"{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_the_tools_entry_points(tmp_path):
    """``python -m ...telemetry.validate DIR|DUMP`` and ``... aggregate
    D0 D1 --out POD``: one JSON verdict line each; exit 0 when good, 1 on
    a bad bundle, 2 on a usage error or an unreadable input."""
    dirs = [_host_bundle(tmp_path, 0, 1, [0.01]),
            _host_bundle(tmp_path, 1, 2, [0.02])]
    pod = str(tmp_path / "pod")
    r = _run("aggregate", *dirs, "--out", pod)
    verdict = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == 0 and verdict["ok"] and verdict["validate"]["ok"]
    r = _run("validate", pod)
    assert r.returncode == 0 and json.loads(r.stdout)["ok"]
    os.remove(os.path.join(dirs[0], "manifest.json"))
    r = _run("validate", dirs[0])
    assert r.returncode == 1 and not json.loads(r.stdout)["ok"]
    r = _run("aggregate", dirs[0], dirs[1], "--out", str(tmp_path / "p2"))
    assert r.returncode == 2
    assert not json.loads(r.stdout.strip().splitlines()[-1])["ok"]
    assert _run("validate").returncode == 2
