"""The control of a cell's comparison: ``python3 perfbench/control.py
--workload <name> --seeds <n> [<n> ...]``.

For each seed it takes the lanes a run of the cell checks and puts the
reference computed in the nearest precision below the configuration's
(float32 -> bfloat16: bf16 bars in, bf16 answers out) in the program's
place, then holds it to the reference as a run holds the program. Each
line of output is one seed's number beside the cell's limit; the control
has to read above it. No program runs, so it needs no card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402
from perfbench.drivers import common  # noqa: E402
from perfbench.reference import compare, sessions  # noqa: E402


def control_reading(cell, seed: int) -> dict:
    """The control's worst factor share over the cell's sampled lanes."""
    drv = harness.driver_module(cell)
    session = sessions.from_config(cell.config["session"])
    got, want = [], []
    for _, rows, codes in drv.control_rows(cell, seed):
        want.append(compare.reference_lanes(*rows, codes, session))
        got.append(compare.control_lanes(*rows, codes, session))
    return common.hold(common.np.concatenate(got),
                       common.np.concatenate(want),
                       cell.mix["check"][common.CHECK], harness.log)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.resolve(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        c = control_reading(cell, seed)[common.CHECK]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": common.CHECK, "value": c["value"],
                          "limit": c["limit"],
                          "fails": c["value"] > c["limit"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
