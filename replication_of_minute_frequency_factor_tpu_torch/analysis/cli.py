"""graftlint CLI: ``python -m replication_of_minute_frequency_factor_tpu_torch
analyze``.

Prints a one-line JSON verdict (the JAX package's convention) and exits
0 iff the tree is clean against the committed baseline. Default run:
Tier A and Tier C over the port's package, and the trace tier over every
registered kernel and the driving-loop wrappers on the card, the report
written to ``analysis_report_torch.json`` at the repo root (diffable,
committed). ``--device cpu`` traces on the CPU; without it and without a
card the trace tier refuses (exit 2), as every entry point of the port
does. The port of the JAX package's ``analysis/cli.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .violations import BASELINE_PATH, Baseline
from .report import REPORT_NAME, build_report, default_report_path, \
    write_report

#: ``--explain <CODE>``: rationale + fix pattern per rule, printable
#: without tracing anything. Every code across the three tiers appears
#: here.
EXPLAIN = {
    "GL-A1": ("torch attribute chain that does not exist on the installed "
              "torch (the jnp.maximum.accumulate incident class): the "
              "call fails only at run time, on the card's host.",
              "Use an attribute that exists on the pinned torch, or gate "
              "behind hasattr with a tested fallback."),
    "GL-A2": ("a Python loop in the kernel layers whose trip count is a "
              "tensor extent (range(t.shape[k]), range(len(t))), or "
              "torch.roll inside a loop, launches one kernel chain per "
              "element — the launch count grows with the data.",
              "Vectorise: windowed ops via ops.rolling (strided gather, "
              "unfold), one batched op over the axis; the one driving "
              "loop lives only in the resident wrappers."),
    "GL-A3": ("host syncs (.item(), .tolist(), .cpu(), .numpy(), "
              "nonzero, torch.cuda.synchronize, np.asarray, float() of a "
              "tensor) in device-hot modules stall the launch queue.",
              "Keep results on the device; fetch only at the declared "
              "boundary modules listed in GLA3_BOUNDARY_SYNCS."),
    "GL-A4": ("resource acquisition (start_trace-style) without a "
              "guaranteed release leaks the resource on any exception "
              "path.",
              "Pair acquire/release in try/finally or a context "
              "manager."),
    "GL-A5": ("raw torch.mean/std/var/median/nan* in models/ silently "
              "disagree with the present-bar mask discipline the kernels "
              "mandate.",
              "Use the ops.masked reductions — same math, explicit "
              "mask semantics."),
    "GL-A6": ("a @register kernel in models/ with no finalize-class "
              "declaration cannot state its exactness class, so the "
              "fast-finalize path must guess.",
              "Declare finalize_class(...) next to the kernel with "
              "one of the three exactness classes."),
    "GL-B0": ("a registered kernel (or a driving-loop wrapper) raised at "
              "the canonical shape — it cannot run at all.",
              "Fix the error; the trace tier's message carries the "
              "originating exception."),
    "GL-B1": ("an ATen op count that grows with the data: a Python loop "
              "over a tensor extent survived into the kernel, one launch "
              "chain per element (in a wrapper: one more batch costs "
              "more than one step).",
              "Vectorise the computation; only the wrappers' ONE "
              "driving loop is allowed (by symbol, never by baseline)."),
    "GL-B2": ("an op that reads or writes float64/complex128 inside a "
              "kernel doubles its bytes and leaves the f32 policy (the "
              "f64 oracle lives in oracle/).",
              "Keep kernel dtypes f32/int32; where f64 is deliberate "
              "(a bit-stable accumulation), baseline it per kernel with "
              "the reason."),
    "GL-B3": ("a host sync inside a kernel (.item(), nonzero, a bool-mask "
              "index, a copy to the CPU) stalls the launch queue on every "
              "batch and fails under set_sync_debug_mode('error').",
              "Keep values on the device: torch.where in place of a "
              "bool index, static sizes in place of data-sized results."),
    "GL-C1": ("a write/RMW of a declared guarded attribute outside "
              "'with self.<lock>:', or a cross-object reach into "
              "another class's guarded internals — exactly the race "
              "that works under CPython coincidence until it "
              "corrupts a scrape mid-flight.",
              "Take the owning lock around the mutation; for "
              "cross-object reads add a locked accessor on the owner "
              "(FleetRouter.inflight() is the pattern). Methods that "
              "genuinely run pre-thread go in the contract's 'init' "
              "tuple; caller-holds-lock helpers go in 'locked' — both "
              "with a docstring saying why."),
    "GL-C2": ("a thread that is not daemon=True blocks interpreter "
              "shutdown; one with no join path leaks; a target that "
              "mutates a foreign class's guarded state races its "
              "owner's lock.",
              "Construct threads daemon=True (literal), register them "
              "on the owner and join in stop()/close()/drain(), or "
              "return the thread to the caller who owns its "
              "lifecycle; route foreign-state writes through a locked "
              "method on the owner."),
    "GL-C3": ("a plain open('w') from a threaded context lets a "
              "scraper/reader see a torn half-written file.",
              "Write '<path>.tmp' then os.replace(tmp, path) — "
              "atomic on POSIX; FlightRecorder.dump is the exemplar."),
    "GL-C4": ("a bare except:pass in a thread run loop turns a real "
              "bug into a silently stalled sampler — nothing in any "
              "scrape says it died.",
              "Count a telemetry counter in the handler "
              "(tel.counter('<plane>.sample_errors', "
              "error=type(e).__name__)) so the failure is "
              "observable, then continue."),
}


def explain(code: str) -> int:
    spec = EXPLAIN.get(code.strip().upper())
    if spec is None:
        print(f"unknown rule code {code!r}; known: "
              + ", ".join(sorted(EXPLAIN)), file=sys.stderr)
        return 2
    why, fix = spec
    print(f"{code.strip().upper()}")
    print(f"  why: {why}")
    print(f"  fix: {fix}")
    return 0


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tier", choices=("ast", "trace", "c", "all"),
                   default="all",
                   help="which tier(s) to run (default: all; the trace "
                        "tier runs every registered kernel under an ATen "
                        "op recorder — on the card, or on the CPU with "
                        "--device cpu; tier c is the concurrency lint "
                        "over the threaded layers)")
    p.add_argument("--explain", default=None, metavar="CODE",
                   help="print the rationale and fix pattern for one "
                        "rule code (e.g. GL-C1) and exit")
    p.add_argument("--baseline", default=BASELINE_PATH,
                   help="accepted-violations file (default: the "
                        "committed package baseline)")
    p.add_argument("--update-baseline", action="store_true",
                   help="accept every NEW violation into --baseline; "
                        "requires --justification")
    p.add_argument("--justification", default="",
                   help="written reason recorded on entries added by "
                        "--update-baseline (mandatory with it)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help=f"where to write the machine-readable report "
                        f"(default: <repo>/{REPORT_NAME}; '-' skips "
                        "writing)")
    p.add_argument("--paths", nargs="*", default=None, metavar="DIR",
                   help="AST/C-tier scan roots (default: the port's "
                        "package); used by the fixture tests")
    p.add_argument("--days", type=int, default=2,
                   help="days extent of the canonical trace shape")
    p.add_argument("--tickers", type=int, default=3,
                   help="tickers extent of the canonical trace shape")
    p.add_argument("--rolling-impl", default="torch",
                   choices=("torch", "cuda"),
                   help="rolling backend the trace tier runs (cuda: the "
                        "hand-written kernel, whose launches the "
                        "fingerprints count under kernel:second_moments; "
                        "on the card the pv_corr family's kernel counts "
                        "under kernel:pv_corr whatever this says)")
    p.add_argument("--device", default=None,
                   help="device the trace tier runs on (default: cuda, "
                        "which must be present; 'cpu' traces on the CPU)")


def run(args: argparse.Namespace) -> int:
    if getattr(args, "explain", None):
        return explain(args.explain)

    device = None
    if args.tier in ("trace", "all"):
        import torch

        device = torch.device("cuda" if args.device is None
                              else args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            print("CUDA is not available; pass --device cpu to trace on "
                  "the CPU", file=sys.stderr)
            return 2

    from .ast_tier import run_ast_tier
    from .trace_tier import SLOTS, run_trace_tier

    violations = []
    n_files = 0
    if args.tier in ("ast", "all"):
        roots = args.paths if args.paths else [None]
        for root in roots:
            vs, nf = run_ast_tier(root)
            violations += vs
            n_files += nf
    concurrency = None
    if args.tier in ("c", "all"):
        from .concurrency_tier import contract_index, run_concurrency_tier

        c_violations = []
        c_files = 0
        contracts = {}
        roots = args.paths if args.paths else [None]
        for root in roots:
            vs, nf = run_concurrency_tier(root)
            c_violations += vs
            c_files += nf
            contracts.update(contract_index(root))
        violations += c_violations
        concurrency = {
            "files_scanned": c_files,
            "contracts": contracts,
            "by_rule": {},
        }
        for v in c_violations:
            concurrency["by_rule"][v.code] = \
                concurrency["by_rule"].get(v.code, 0) + 1
        concurrency["by_rule"] = dict(
            sorted(concurrency["by_rule"].items()))
    fingerprints = None
    resident_fps = None
    session_fps = None
    shape = None
    if args.tier in ("trace", "all"):
        from .trace_tier import run_resident_tier, run_session_tier

        shape = (args.days, args.tickers, SLOTS)
        kw = dict(days=args.days, tickers=args.tickers,
                  rolling_impl=args.rolling_impl, device=device)
        vs, fingerprints = run_trace_tier(**kw)
        violations += vs
        # the driving-loop wrappers at the same canonical shape: their
        # ONE loop is allowed by symbol (trace_tier.RESIDENT_WRAPPERS),
        # never by baseline entry
        vs, resident_fps = run_resident_tier(**kw)
        violations += vs
        # every registered market session's shape under the same
        # contracts
        vs, session_fps = run_session_tier(**kw)
        violations += vs

    # an entry of a tier that did not run is not stale
    ran = {"ast": ("GL-A",), "trace": ("GL-B",), "c": ("GL-C",),
           "all": ("GL-A", "GL-B", "GL-C")}[args.tier]

    def split(baseline):
        new, accepted, stale = baseline.split(violations)
        return new, accepted, [e for e in stale
                               if e.get("code", "").startswith(ran)]

    baseline = Baseline.load(args.baseline)
    new, accepted, stale = split(baseline)

    if args.update_baseline and new:
        if not args.justification.strip():
            print("--update-baseline requires --justification "
                  "(every accepted violation must say why)",
                  file=sys.stderr)
            return 2
        baseline.extend(new, args.justification)
        baseline.save(args.baseline)
        new, accepted, stale = split(Baseline.load(args.baseline))

    report = build_report(new, accepted, stale,
                          fingerprints=fingerprints,
                          files_scanned=n_files, shape=shape,
                          resident_fingerprints=resident_fps,
                          session_fingerprints=session_fps,
                          concurrency=concurrency,
                          device=None if device is None else str(device))
    report_path = args.report
    if report_path is None:
        report_path = default_report_path()
    if report_path != "-":
        write_report(report_path, report)

    for v in new:
        print(f"{v.location()}: {v.code} [{v.symbol}] {v.message}",
              file=sys.stderr)
    for e in stale:
        print(f"stale baseline entry (violation no longer occurs — "
              f"delete it): {e}", file=sys.stderr)
    verdict = {"ok": not new, "tier": args.tier, **report["verdict"]}
    if fingerprints is not None:
        verdict["kernels"] = len(fingerprints)
        verdict["device"] = str(device)
    if resident_fps is not None:
        verdict["resident_wrappers"] = len(resident_fps)
    if session_fps is not None:
        verdict["sessions"] = len(session_fps)
    if concurrency is not None:
        verdict["contracts"] = len(concurrency["contracts"])
    if report_path != "-":
        verdict["report"] = report_path
    print(json.dumps(verdict))
    return 0 if not new else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m replication_of_minute_frequency_factor_tpu_torch "
             "analyze",
        description=__doc__)
    add_args(ap)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
