"""Command-line driver: ``python -m replication_of_minute_frequency_factor_tpu_torch``.

The port of the JAX package's CLI: compute exposures, then evaluate them,
on the card (``--device cpu`` runs on the CPU; without a card and without
it, both raise):

    # compute all 58 factors over a directory of day files
    python -m replication_of_minute_frequency_factor_tpu_torch compute \
        --minute-dir data/kline --cache data/factors.parquet

    # evaluate one factor against daily price/volume data
    python -m replication_of_minute_frequency_factor_tpu_torch evaluate \
        --factor vol_return1min --cache data/factors.parquet \
        --daily-pv data/price_volume.parquet --plots out/

    # list the factor catalog
    python -m replication_of_minute_frequency_factor_tpu_torch list-factors

    # the runtime: torch, CUDA, the card, nvcc, the kernel build
    python -m replication_of_minute_frequency_factor_tpu_torch doctor

    # the long-lived factor server over HTTP (port 0 = ephemeral,
    # printed on startup), or N in-process demo queries
    python -m replication_of_minute_frequency_factor_tpu_torch serve \
        --port 0
    python -m replication_of_minute_frequency_factor_tpu_torch serve \
        --demo 6 --synthetic-days 6 --synthetic-tickers 16

    # with the factor-discovery engine: POST /v1/discover runs a
    # bounded search, the winner is served as a disc_<hash> factor
    python -m replication_of_minute_frequency_factor_tpu_torch serve \
        --port 0 --research --research-dir out/discoveries

    # observability demo: run the device pipeline over synthetic day
    # files and write the telemetry bundle (manifest.json,
    # metrics.jsonl, trace.json)
    python -m replication_of_minute_frequency_factor_tpu_torch \
        --telemetry-dir out/

    # the same, profiled: a torch.profiler trace into out/prof/, and
    # the attribution report embeds its per-op-class summary
    python -m replication_of_minute_frequency_factor_tpu_torch \
        --telemetry-dir out/ --profile-dir out/prof/

``compute --profile-dir DIR`` captures a trace of the run;
``compute --backend numpy`` runs the f64 oracle on the host;
``compute --backend polars`` runs the reference's own ``cal_*`` code
(the hash-pinned tree at ``REFDIFF_REFERENCE_DIR``) on real polars or
the port's audited shim (``refdiff/``), on the host, with no repo
checkout needed; with no reference tree it fails before reading a day
and creates no cache.
``compute --mesh-tickers N`` shards the tickers axis over N ranks: the
command spawns them itself (each on ``cuda:{rank % device_count}``, NCCL
when every rank has a card of its own, else gloo), or joins the group it
was started in under ``torchrun`` (``RANK``/``WORLD_SIZE`` set; only
rank 0 prints):

    python -m replication_of_minute_frequency_factor_tpu_torch compute \
        --minute-dir data/kline --cache data/factors.parquet \
        --mesh-tickers 2

``serve --fleet N`` runs N replicas as one pod behind one front door
(``fleet/``): every visible card split into N groups, or, with
``--device D``, N replicas sharing ``D`` (``--device cpu`` runs them on
the CPU). ``--demo K`` routes K queries and prints the pod summary:

    python -m replication_of_minute_frequency_factor_tpu_torch serve \
        --fleet 2 --demo 12

``analyze`` is the static contract analysis (``analysis/``): the AST and
concurrency lints over the port's package and the ATen op trace of every
registered kernel, on the card (``--device cpu`` traces on the CPU); it
exits 0 iff the tree is clean against the committed baseline and writes
``analysis_report_torch.json`` (never the JAX package's report):

    python -m replication_of_minute_frequency_factor_tpu_torch analyze \
        --tier all --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda, which "
                        "must be present; 'cpu' runs on the CPU)")


def _add_compute(sub: "argparse._SubParsersAction") -> None:
    p = sub.add_parser(
        "compute", help="compute factor exposures over a minute-bar dir "
        "(incremental: resumes past the cache's max date)")
    p.add_argument("--minute-dir", required=True,
                   help="directory of YYYYMMDD*.parquet day files")
    p.add_argument("--cache", required=True,
                   help="multi-factor columnar cache parquet (created or "
                   "appended incrementally, atomic writes)")
    p.add_argument("--factors", default="all",
                   help="comma-separated factor names, or 'all' (default)")
    p.add_argument("--days-per-batch", type=int, default=None)
    p.add_argument("--mesh-tickers", type=int, default=None, metavar="N",
                   help="shard the tickers axis over N ranks (spawned "
                        "here, or the torchrun group this runs in)")
    p.add_argument("--no-wire", action="store_true",
                   help="ship raw f32 instead of the compact wire format")
    p.add_argument("--fixed-quirks", action="store_true",
                   help="use mathematically-intended definitions instead "
                   "of replicating reference quirks Q1-Q4")
    p.add_argument("--backend", choices=("torch", "numpy", "polars"),
                   default=None,
                   help="execution backend: torch (the device pipeline), "
                        "numpy (f64 oracle), polars (the reference's own "
                        "kernels; slow, differential use)")
    p.add_argument("--rolling-impl", choices=("cuda", "torch"),
                   default=None,
                   help="mmt_ols_* rolling backend: cuda (the hand-written "
                        "Hopper kernel) or torch (its plain version)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the run here")
    p.add_argument("--retry-failed", action="store_true",
                   help="also recompute the days in <cache>.failures.json "
                        "(a plain rerun only resumes past the cached max "
                        "date, so previously-failed days stay lost "
                        "without this)")
    # SUPPRESS: only set when present, so it can't clobber the
    # main-parser --telemetry-dir given before the subcommand
    p.add_argument("--telemetry-dir", default=argparse.SUPPRESS,
                   metavar="DIR",
                   help="write run telemetry (manifest.json, "
                        "metrics.jsonl, trace.json, attribution.json) "
                        "into DIR and print an end-of-run summary")
    p.add_argument("--quiet", action="store_true")
    _add_device(p)


def _add_evaluate(sub: "argparse._SubParsersAction") -> None:
    p = sub.add_parser(
        "evaluate", help="coverage / IC / group backtest for one factor")
    p.add_argument("--factor", required=True)
    p.add_argument("--cache", required=True,
                   help="exposure source: the compute cache parquet (or a "
                   "single-factor exposure parquet)")
    p.add_argument("--daily-pv", required=True,
                   help="daily price/volume parquet (CSMAR column names)")
    p.add_argument("--future-days", type=int, default=5)
    p.add_argument("--frequency", default="month",
                   choices=("week", "month", "quarter", "year"))
    p.add_argument("--group-num", type=int, default=5)
    p.add_argument("--weight", default=None, choices=("tmc", "cmc"),
                   help="market-cap weighting for group returns "
                   "(default: equal)")
    p.add_argument("--plots", default=None, metavar="DIR",
                   help="write coverage/IC/group charts into DIR "
                   "(headless; needs matplotlib; omit to skip rendering)")
    _add_device(p)


def _add_list(sub: "argparse._SubParsersAction") -> None:
    p = sub.add_parser("list-factors", help="print the factor catalog")
    p.add_argument("--json", action="store_true", dest="as_json")


def _add_doctor(sub: "argparse._SubParsersAction") -> None:
    sub.add_parser(
        "doctor", help="environment diagnostics: torch and CUDA versions, "
        "the card, nvcc, the kernel build directory, the native encoder, "
        "config")


def _add_serve(sub: "argparse._SubParsersAction") -> None:
    p = sub.add_parser(
        "serve", help="long-lived factor service: warm callables, "
        "device-resident exposure cache, async batching queue; "
        "HTTP/JSON on --port, or --demo N for an in-process smoke")
    p.add_argument("--minute-dir", default=None,
                   help="serve a directory of day files (default: a "
                        "synthetic source)")
    p.add_argument("--synthetic-days", type=int, default=32)
    p.add_argument("--synthetic-tickers", type=int, default=64)
    p.add_argument("--session", default=None, metavar="NAME",
                   help="market session of the SYNTHETIC source "
                        "(markets/registry.py: cn_ashare_240 us_390 "
                        "hk_halfday crypto_1440; default cn_ashare_240)."
                        " --minute-dir sources carry cn wall-clock "
                        "stamps and ignore this.")
    p.add_argument("--factors", default="all",
                   help="comma-separated factor names, or 'all' (default)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787,
                   help="HTTP port (0 = ephemeral; printed on startup)")
    p.add_argument("--cache-mb", type=int, default=256,
                   help="device-byte budget of the exposure cache")
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="micro-batch collection window")
    p.add_argument("--stream", action="store_true",
                   help="also host the online intraday engine: POST "
                        "/v1/ingest advances the streaming carry, query "
                        "kind 'intraday' serves partial-day exposures")
    p.add_argument("--stream-batches", default="1",
                   help="comma-separated ingest micro-batch minute "
                        "counts warmed at startup (default: 1)")
    p.add_argument("--research", action="store_true",
                   help="also host the factor-discovery engine: POST "
                        "/v1/discover runs a bounded-generations "
                        "evolutionary search, the winning genome "
                        "registers as a live disc_<hash> factor, GET "
                        "/v1/factors lists built-in + discovered")
    p.add_argument("--research-dir", default=None, metavar="DIR",
                   help="persist discovered-genome records as "
                        "<name>.json under DIR (reloaded at startup)")
    p.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="run N replicas as one pod behind one front "
                        "door: the visible cards split into N groups "
                        "(with --device, N replicas on that device); "
                        "0 = a single server")
    p.add_argument("--demo", type=int, default=None, metavar="N",
                   help="answer N in-process queries (factors/IC/decile "
                        "cycle), print a JSON summary, exit — no HTTP")
    p.add_argument("--transport", choices=("edge", "legacy"),
                   default="edge",
                   help="front-door transport: the evented selectors "
                        "loop with keep-alive/pipelining/binary-wire "
                        "answers (edge, default) or the stdlib "
                        "thread-per-connection server (legacy)")
    p.add_argument("--telemetry-dir", default=argparse.SUPPRESS,
                   metavar="DIR",
                   help="write the run's telemetry bundle into DIR on "
                        "shutdown")
    _add_device(p)


def _add_analyze(sub: "argparse._SubParsersAction") -> None:
    from .analysis import cli as analysis_cli
    p = sub.add_parser(
        "analyze", help="graftlint: static AST + ATen op-trace + "
        "concurrency contract analysis of the factor engine; exits 0 iff "
        "clean against the committed baseline")
    analysis_cli.add_args(p)


def cmd_analyze(args: argparse.Namespace) -> int:
    from .analysis import cli as analysis_cli
    return analysis_cli.run(args)


def cmd_serve(args: argparse.Namespace) -> int:
    import os
    import time

    from .models.registry import factor_names
    from .serve import (FactorServer, MinuteDirSource, ServeConfig,
                        SyntheticSource, serve_frontdoor)
    from .telemetry import Telemetry, set_telemetry

    all_names = factor_names()
    names = (all_names if args.factors == "all"
             else tuple(s.strip() for s in args.factors.split(",")
                        if s.strip()))
    unknown = [n for n in names if n not in all_names]
    if unknown:
        print(f"unknown factor(s): {', '.join(unknown)} "
              "(see list-factors)", file=sys.stderr)
        return 2
    tel = set_telemetry(Telemetry())
    if args.minute_dir:
        source = MinuteDirSource(args.minute_dir)
    else:
        source = SyntheticSource(n_days=args.synthetic_days,
                                 n_tickers=args.synthetic_tickers,
                                 session=args.session)
    scfg = ServeConfig(batch_window_s=args.batch_window_ms / 1e3,
                       cache_bytes=args.cache_mb * 1024 * 1024,
                       research_dir=args.research_dir,
                       edge=args.transport)
    telemetry_dir = getattr(args, "telemetry_dir", None)

    def _write_bundle():
        if telemetry_dir:
            tel.write(telemetry_dir,
                      manifest_extra={"run_kind": "serve"})
            print(tel.summary(), file=sys.stderr)

    stream_batches = tuple(int(s) for s in
                           str(args.stream_batches).split(",")
                           if s.strip())
    if args.fleet > 0:
        return _cmd_serve_fleet(args, source, names, scfg,
                                stream_batches or (1,), tel, _write_bundle)
    from . import kernels
    builds0 = kernels.build_count()
    with FactorServer(source, names=names, serve_cfg=scfg,
                      telemetry=tel, stream=args.stream,
                      stream_batches=stream_batches or (1,),
                      research=args.research,
                      device=args.device) as server:
        if args.demo is not None:
            for q in _demo_queries(args.demo, source, names):
                server.submit(q).result(60)
            reg = tel.registry
            lat = reg.histogram_stats("serve.request_seconds",
                                      kind="ic") or {}
            _write_bundle()
            print(json.dumps({
                "demo_requests": args.demo,
                "factors": len(names),
                "days": source.n_days,
                "tickers": source.n_tickers,
                "dispatches": int(reg.counter_total("serve.dispatches")),
                "cache_hits": int(reg.counter_value("serve.cache",
                                                    outcome="hit")),
                # the kernel-library builds and loads the server made
                # (the JAX package counts XLA compiles here)
                "compiles": kernels.build_count() - builds0,
                "ic_p50_s": lat.get("p50"),
            }))
            return 0
        door = serve_frontdoor(server, host=args.host,
                               port=args.port)
        print(json.dumps({"serving": True, "host": args.host,
                          "port": door.server_address[1],
                          "transport": args.transport,
                          "factors": len(names),
                          "days": source.n_days,
                          "device": str(server.device),
                          "pid": os.getpid()}), flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            door.shutdown()
            _write_bundle()
    return 0


def _demo_queries(n: int, source, names):
    """``serve --demo N``'s queries: factors, IC and decile in turn, each
    over one of the source's day-ranges of up to 8 days and one factor."""
    from .serve import Query

    w = max(2, min(8, source.n_days))
    n_ranges = max(1, source.n_days // w)
    out = []
    for i in range(n):
        start = (i % n_ranges) * w
        name = names[i % len(names)]
        kind = ("factors", "ic", "decile")[i % 3]
        out.append(Query(kind, start, start + w, names=(name,))
                   if kind == "factors"
                   else Query(kind, start, start + w, factor=name))
    return out


def _cmd_serve_fleet(args, source, names, scfg, stream_batches, tel,
                     write_bundle) -> int:
    """``serve --fleet N``: one pod front door over N replicas. The
    replicas split every visible card (``partition_devices``), or, with
    ``--device D``, all run on ``D``. ``--demo K`` answers K queries
    through the ROUTER and prints the pod summary (per-replica dispatch
    spread included); otherwise the fleet's front door serves until
    interrupted."""
    import os
    import time

    import torch

    from . import kernels
    from .fleet import FactorFleet, serve_fleet_frontdoor

    devices = (None if args.device is None
               else [torch.device(args.device)] * args.fleet)
    builds0 = kernels.build_count()
    with FactorFleet(source, args.fleet, names=names, serve_cfg=scfg,
                     stream=args.stream, stream_batches=stream_batches,
                     telemetry=tel, devices=devices) as fleet:
        if args.demo is not None:
            for q in _demo_queries(args.demo, source, names):
                fleet.submit(q).result(120)
            reg = fleet.pod_registry()
            health = fleet.health()
            write_bundle()
            print(json.dumps({
                "demo_requests": args.demo,
                "fleet": args.fleet,
                "live_replicas": health["pod"]["live"],
                "factors": len(names),
                "days": source.n_days,
                "tickers": source.n_tickers,
                "dispatches": int(reg.counter_total("serve.dispatches")),
                "routed": int(reg.counter_total("fleet.routed")),
                "cache_hits": int(reg.counter_value("serve.cache",
                                                    outcome="hit")),
                # the kernel-library builds and loads the pod made (the
                # JAX package counts XLA compiles here)
                "compiles": kernels.build_count() - builds0,
                "per_replica_dispatches": {
                    r.label: int(r.telemetry.registry.counter_total(
                        "serve.dispatches")) for r in fleet.replicas},
            }))
            return 0
        door = serve_fleet_frontdoor(fleet, host=args.host,
                                     port=args.port,
                                     transport=args.transport)
        print(json.dumps({
            "serving": True, "fleet": args.fleet,
            "host": args.host, "port": door.server_address[1],
            "transport": args.transport,
            "factors": len(names), "days": source.n_days,
            "replicas": [r.label for r in fleet.replicas],
            "devices": {r.label: [str(d) for d in r.devices]
                        for r in fleet.replicas},
            "pid": os.getpid()}), flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            door.shutdown()
            write_bundle()
    return 0


def cmd_compute(args: argparse.Namespace) -> int:
    from .config import Config
    from .models.registry import factor_names
    from .pipeline import compute_exposures
    from .telemetry import Telemetry, set_telemetry

    all_names = factor_names()
    names = (all_names if args.factors == "all"
             else tuple(s.strip() for s in args.factors.split(",") if
                        s.strip()))
    unknown = [n for n in names if n not in all_names]
    if unknown:
        print(f"unknown factor(s): {', '.join(unknown)} "
              "(see list-factors)", file=sys.stderr)
        return 2
    cfg = Config.from_env()  # honor MFF_* like every other entry point
    if args.backend is not None:
        cfg.backend = args.backend
    if args.days_per_batch is not None:
        cfg.days_per_batch = args.days_per_batch
    if args.no_wire:
        cfg.wire_transfer = False
    if args.fixed_quirks:
        cfg.replicate_quirks = False
    if args.rolling_impl is not None:
        cfg.rolling_impl = args.rolling_impl
    if args.profile_dir is not None:
        cfg.profile_dir = args.profile_dir
    telemetry_dir = getattr(args, "telemetry_dir", None)
    if args.mesh_tickers is not None:
        import os

        if args.mesh_tickers < 1:
            print("--mesh-tickers takes N >= 1", file=sys.stderr)
            return 2
        cfg.mesh_shape = (1, args.mesh_tickers)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            from .parallel import multihost
            multihost.initialize(device=args.device)
        elif telemetry_dir and args.mesh_tickers > 1:
            print("compute --mesh-tickers spawns its ranks: --telemetry-dir "
                  "needs them started under torchrun", file=sys.stderr)
            return 2
    tel = None
    if telemetry_dir:
        # install as the process default so the data/wire layer
        # counters land in the same stream the pipeline uses
        tel = set_telemetry(Telemetry())
    table = compute_exposures(args.minute_dir, names,
                              cache_path=args.cache, cfg=cfg,
                              progress=not args.quiet,
                              retry_failed=args.retry_failed,
                              telemetry=tel,
                              device=args.device)  # saves cache
    if table is None:  # a rank other than 0 of a torchrun group
        return 0
    n_days = len(set(map(str, table.columns["date"])))
    out = {
        "rows": len(table), "days": n_days,
        "factors": len(table.factor_names),
        "failed_days": len(table.failures) if table.failures else 0,
        "cache": args.cache,
    }
    if tel is not None:
        out["telemetry"] = _write_telemetry(tel, telemetry_dir, cfg, table,
                                            "compute")
    print(json.dumps(out))
    return 0


def _write_telemetry(tel, telemetry_dir: str, cfg, table,
                     run_kind: str) -> dict:
    """The run's bundle plus ``attribution.json`` (stage seconds, the
    wall-clock reconciliation and, with ``cfg.profile_dir``, the trace's
    ``trace`` summary) into ``telemetry_dir``; prints the end-of-run
    summary to stderr and returns ``{artifact: path}``."""
    import os

    from .telemetry.attribution import build_report, write_report

    paths = tel.write(telemetry_dir, cfg=cfg,
                      manifest_extra={"run_kind": run_kind})
    report = build_report(table.timings,
                          reconciliation=getattr(table, "reconciliation",
                                                 None),
                          profile_dir=cfg.profile_dir,
                          tolerance=cfg.attribution_tolerance)
    paths["attribution"] = write_report(
        os.path.join(telemetry_dir, "attribution.json"), report)
    print(tel.summary(), file=sys.stderr)
    return paths


def run_synthetic_pipeline(telemetry_dir: str, n_days: int = 3,
                           n_codes: int = 16, device=None,
                           profile_dir: Optional[str] = None) -> int:
    """Zero-setup observability demo: synthesize a few day files, run the
    REAL device pipeline over them (grid + wire-encode + factor graph +
    cache-shaped fetch), and write the telemetry bundle plus an
    attribution report into ``telemetry_dir``. With ``profile_dir`` the
    run sits inside a crash-safe ``torch.profiler`` capture and the
    report embeds the post-processed per-op-class trace summary."""
    import os
    import tempfile

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from .config import Config
    from .data.synthetic import synth_day
    from .pipeline import compute_exposures
    from .telemetry import Telemetry, set_telemetry

    tel = set_telemetry(Telemetry())
    rng = np.random.default_rng(0)
    names = ("vol_return1min", "mmt_am", "liq_openvol")
    with tempfile.TemporaryDirectory() as md:
        for i in range(n_days):
            ds = str(np.datetime64("2024-01-02") + i)
            cols = synth_day(rng, n_codes=n_codes, date=ds,
                             missing_prob=0.05)
            arrays = {"code": pa.array([str(c) for c in cols["code"]]),
                      "time": pa.array(cols["time"])}
            for k in ("open", "high", "low", "close", "volume"):
                arrays[k] = pa.array(cols[k])
            pq.write_table(pa.table(arrays),
                           os.path.join(md, ds.replace("-", "")
                                        + ".parquet"))
        cfg = Config.from_env()
        cfg.minute_dir = md
        cfg.days_per_batch = 2
        if profile_dir:
            cfg.profile_dir = profile_dir
        table = compute_exposures(md, names, cfg=cfg, progress=False,
                                  telemetry=tel, device=device)
    paths = _write_telemetry(tel, telemetry_dir, cfg, table,
                             "synthetic_pipeline")
    rec = table.reconciliation
    print(json.dumps({"rows": len(table),
                      "days": n_days, "factors": len(names),
                      "reconciliation_ok": rec["ok"],
                      "unattributed_s": rec["unattributed_s"],
                      "telemetry": paths}))
    return 0


def cmd_evaluate(args: argparse.Namespace) -> int:
    import os

    from .minfreq import MinFreqFactor
    from .pipeline import ExposureTable

    table = ExposureTable.load(args.cache)
    if args.factor not in table.factor_names:
        print(f"factor {args.factor!r} not in cache "
              f"(has: {', '.join(table.factor_names)})", file=sys.stderr)
        return 2
    cols = table.single(args.factor)
    f = MinFreqFactor(args.factor, device=args.device).set_exposure(
        cols["code"], cols["date"], cols[args.factor])

    plots = args.plots
    if plots:
        os.makedirs(plots, exist_ok=True)

    def path(kind: str) -> Optional[str]:
        return (os.path.join(plots, f"{args.factor}_{kind}.png")
                if plots else None)

    f.coverage(plot=bool(plots), save_path=path("coverage"))
    f.ic_test(future_days=args.future_days, plot=bool(plots),
              save_path=path("ic"), daily_pv_path=args.daily_pv)
    f.group_test(frequency=args.frequency, weight_param=args.weight,
                 group_num=args.group_num, plot=bool(plots),
                 save_path=path("group"), daily_pv_path=args.daily_pv)

    def stat(x):
        # ic_test leaves the stats as None when no usable cross-section
        # exists (no shared (code, date) with finite forward returns) —
        # report null rather than crashing on float(None)
        return round(float(x), 6) if x is not None else None

    report = {
        "factor": args.factor,
        "IC": stat(f.IC), "ICIR": stat(f.ICIR),
        "rank_IC": stat(f.rank_IC), "rank_ICIR": stat(f.rank_ICIR),
    }
    if f.IC is None:
        print("note: IC stats are null — exposure and daily-pv share no "
              "usable (code, date) cross-section (check code formats, "
              "date overlap, and --future-days)", file=sys.stderr)
    if plots:
        # a chart can be legitimately skipped (e.g. the group backtest
        # needs >=2 periods after the one-period lookahead lag) — say so
        # instead of silently writing fewer files than asked
        report["plots_written"] = [
            k for k in ("coverage", "ic", "group")
            if os.path.exists(path(k))]
        skipped = [k for k in ("coverage", "ic", "group")
                   if k not in report["plots_written"]]
        if skipped:
            report["plots_skipped"] = skipped
            print(f"note: no {'/'.join(skipped)} chart — too little data "
                  f"at this frequency (group needs >=2 "
                  f"{args.frequency} periods after the 1-period lag)",
                  file=sys.stderr)
    print(json.dumps(report))
    return 0


def cmd_list_factors(args: argparse.Namespace) -> int:
    from .models.registry import factor_names
    names = factor_names()
    if args.as_json:
        print(json.dumps(list(names)))
        return 0
    by_family: dict = {}
    for n in names:
        by_family.setdefault(n.split("_", 1)[0], []).append(n)
    for fam in sorted(by_family):
        print(f"{fam} ({len(by_family[fam])}):")
        for n in by_family[fam]:
            print(f"  {n}")
    print(f"total: {len(names)}")
    return 0


def cmd_doctor(args: argparse.Namespace) -> int:
    """Diagnose the runtime: the torch build, the card, the CUDA
    toolchain the kernels build with, the native encoder and the config.
    Exits 0 only when CUDA is available."""
    import dataclasses
    import os

    import torch

    from . import kernels, native
    from .config import get_config

    cuda = torch.cuda.is_available()
    report = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else []),
    }
    try:
        report["nvcc"] = kernels.nvcc_path()
    except RuntimeError as e:
        report["nvcc"] = None
        report["nvcc_error"] = str(e)
    report["kernel_build_dir"] = str(kernels.BUILD_DIR)
    report["kernels_built"] = {
        name: kernels.library_path(name).exists()
        for name in kernels.SOURCES}
    report["native_encoder"] = "built" if native.available() else (
        "unavailable (no C++ toolchain?) — numpy fallback in use")
    report["config"] = dataclasses.asdict(get_config())
    report["mff_env_overrides"] = {
        k: v for k, v in os.environ.items() if k.startswith("MFF_")}
    print(json.dumps(report, indent=2))
    return 0 if cuda else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m replication_of_minute_frequency_factor_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="with no subcommand: run the synthetic demo "
                         "pipeline and write its telemetry bundle into "
                         "DIR (with `compute`, pass the flag after the "
                         "subcommand)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="with --telemetry-dir and no subcommand: wrap the "
                         "synthetic demo in a crash-safe torch.profiler "
                         "capture into DIR and embed the post-processed "
                         "trace summary in the attribution report")
    ap.add_argument("--device", dest="demo_device", default=None,
                    help="with --telemetry-dir and no subcommand: the "
                         "torch device the demo runs on (default: cuda, "
                         "which must be present; 'cpu' runs on the CPU)")
    sub = ap.add_subparsers(dest="cmd", required=False)
    _add_compute(sub)
    _add_evaluate(sub)
    _add_list(sub)
    _add_doctor(sub)
    _add_serve(sub)
    _add_analyze(sub)
    args = ap.parse_args(argv)
    if args.cmd is None:
        if args.telemetry_dir:
            return run_synthetic_pipeline(args.telemetry_dir,
                                          device=args.demo_device,
                                          profile_dir=args.profile_dir)
        ap.error("a subcommand is required (or --telemetry-dir DIR for "
                 "the synthetic telemetry demo)")
    return {"compute": cmd_compute, "evaluate": cmd_evaluate,
            "list-factors": cmd_list_factors,
            "doctor": cmd_doctor, "serve": cmd_serve,
            "analyze": cmd_analyze}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
