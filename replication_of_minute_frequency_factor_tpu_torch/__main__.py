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

The JAX package's ``serve`` and ``analyze`` subcommands and its
``--backend``, ``--mesh-tickers``, ``--profile-dir`` and
``--telemetry-dir`` flags wait for the slices that port what they drive.
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
    p.add_argument("--no-wire", action="store_true",
                   help="ship raw f32 instead of the compact wire format")
    p.add_argument("--fixed-quirks", action="store_true",
                   help="use mathematically-intended definitions instead "
                   "of replicating reference quirks Q1-Q4")
    p.add_argument("--rolling-impl", choices=("cuda", "torch"),
                   default=None,
                   help="mmt_ols_* rolling backend: cuda (the hand-written "
                        "Hopper kernel) or torch (its plain version)")
    p.add_argument("--retry-failed", action="store_true",
                   help="also recompute the days in <cache>.failures.json "
                        "(a plain rerun only resumes past the cached max "
                        "date, so previously-failed days stay lost "
                        "without this)")
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


def cmd_compute(args: argparse.Namespace) -> int:
    from .config import Config
    from .models.registry import factor_names
    from .pipeline import compute_exposures

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
    if args.days_per_batch is not None:
        cfg.days_per_batch = args.days_per_batch
    if args.no_wire:
        cfg.wire_transfer = False
    if args.fixed_quirks:
        cfg.replicate_quirks = False
    if args.rolling_impl is not None:
        cfg.rolling_impl = args.rolling_impl
    table = compute_exposures(args.minute_dir, names,
                              cache_path=args.cache, cfg=cfg,
                              progress=not args.quiet,
                              retry_failed=args.retry_failed,
                              device=args.device)  # saves cache
    n_days = len(set(map(str, table.columns["date"])))
    print(json.dumps({
        "rows": len(table), "days": n_days,
        "factors": len(table.factor_names),
        "failed_days": len(table.failures) if table.failures else 0,
        "cache": args.cache,
    }))
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
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_compute(sub)
    _add_evaluate(sub)
    _add_list(sub)
    _add_doctor(sub)
    args = ap.parse_args(argv)
    return {"compute": cmd_compute, "evaluate": cmd_evaluate,
            "list-factors": cmd_list_factors,
            "doctor": cmd_doctor}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
