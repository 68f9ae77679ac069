"""Run the port's fuzz harnesses.

    python -m replication_of_minute_frequency_factor_tpu_torch.fuzz \
        HARNESS LO HI [--device cuda|cpu] [--jobs N] [--tree PATH]
    python -m replication_of_minute_frequency_factor_tpu_torch.fuzz \
        --all LO HI [--device cuda|cpu]
    python -m replication_of_minute_frequency_factor_tpu_torch.fuzz \
        --pinned [--device cuda|cpu]

``HARNESS`` is one of :data:`..fuzz.HARNESSES`; seeds ``[LO, HI)``.
``--device`` defaults to the card and raises without one. Each failed
seed is printed, and each harness's last line is ``DONE n seeds, k
failures: [...]``; with ``--all`` a last ``DONE`` line sums every
harness. ``--jobs N`` splits each harness's seed window over N processes
(each on the same device). ``--tree PATH`` points the refdiff harness at
another reference tree. ``--pinned`` replays the parity suite's pinned
fuzz seeds and kitchen-sink days. Exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import ast
import os
import subprocess
import sys
import time

from . import HARNESSES, harness

_DONE = "DONE "


def run_one(name: str, lo: int, hi: int, device, tree=None) -> list:
    mod = harness(name)
    if name == "refdiff":
        return mod.run(lo, hi, device, tree=tree)
    return mod.run(lo, hi, device)


def run_split(name: str, lo: int, hi: int, device, jobs: int,
              tree=None) -> list:
    """The seed window in ``jobs`` contiguous parts, one process each,
    all started together; their output is printed part by part. Returns
    the failed seeds (a part that exits without its ``DONE`` line counts
    its whole window as failed)."""
    bounds = [lo + (hi - lo) * i // jobs for i in range(jobs + 1)]
    procs = []
    for a, b in zip(bounds, bounds[1:]):
        if a == b:
            continue
        cmd = [sys.executable, "-m", __package__, name, str(a), str(b)]
        if device is not None:
            cmd += ["--device", str(device)]
        if tree is not None:
            cmd += ["--tree", str(tree)]
        procs.append(((a, b), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fails = []
    for (a, b), p in procs:
        out, _ = p.communicate()
        lines = out.splitlines()
        done = [ln for ln in lines if ln.startswith(_DONE)]
        for ln in lines:
            if not ln.startswith(_DONE):
                print(ln)
        if not done:
            print(f"{name} [{a}, {b}): exited {p.returncode} without its "
                  "summary line", flush=True)
            fails += list(range(a, b))
            continue
        fails += ast.literal_eval(done[-1].split(": ", 1)[1])
    print(f"DONE {hi - lo} seeds, {len(fails)} failures: {fails}",
          flush=True)
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m replication_of_minute_frequency_factor_tpu_torch."
             "fuzz", description=__doc__.split("\n\n")[0])
    ap.add_argument("window", nargs="*", metavar="[HARNESS] LO HI",
                    help=f"one of {', '.join(HARNESSES)} (none with "
                         "--all), then the seed window [LO, HI)")
    ap.add_argument("--all", action="store_true",
                    help="run every harness over the window")
    ap.add_argument("--pinned", action="store_true",
                    help="replay the parity suite's pinned seeds")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or "
                         "cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes each harness's window is split over")
    ap.add_argument("--tree", default=None,
                    help="the refdiff harness's reference tree")
    args = ap.parse_args(argv)
    if not __debug__:
        ap.error("the harnesses check with assert: run without -O")
    if args.pinned:
        if args.window or args.all:
            ap.error("--pinned takes no harness and no window")
        from .parity import run_pinned

        return 1 if run_pinned(args.device) else 0
    want = 2 if args.all else 3
    if len(args.window) != want:
        ap.error("expected --all LO HI or HARNESS LO HI")
    if not args.all and args.window[0] not in HARNESSES:
        ap.error(f"unknown harness {args.window[0]!r}; expected one of "
                 f"{', '.join(HARNESSES)}")
    try:
        args.lo, args.hi = (int(v) for v in args.window[-2:])
    except ValueError:
        ap.error(f"LO and HI are seeds: {args.window[-2:]}")
    names = HARNESSES if args.all else (args.window[0],)
    from . import device_of

    device_of(args.device)
    total = []
    for name in names:
        t0 = time.perf_counter()
        print(f"== {name} [{args.lo}, {args.hi}) on "
              f"{args.device or 'cuda'}", flush=True)
        if args.jobs > 1:
            fails = run_split(name, args.lo, args.hi, args.device,
                              args.jobs, args.tree)
        else:
            fails = run_one(name, args.lo, args.hi, args.device, args.tree)
        print(f"== {name}: {len(fails)} failures in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        total += [(name, s) for s in fails]
    if args.all:
        print(f"DONE {len(names)} harnesses x [{args.lo}, {args.hi}), "
              f"{len(total)} failures: {total}", flush=True)
    return 1 if total else 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
