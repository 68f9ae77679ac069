"""Differential fuzz harnesses of the port.

The port's copy of the JAX package's ``tools/fuzz/``: each harness holds
a part of the port, run on a device, against an independent reference
that needs no JAX — the port's f64 oracle, numpy, scipy or pandas — over
seeded random cases (:mod:`.scenarios`), so a harness runs on the card's
machine as it is. Seed N of a harness is the JAX harness's seed N.

Each harness module exposes ``run(lo, hi, device) -> failures`` and does
nothing when imported; ``python -m
replication_of_minute_frequency_factor_tpu_torch.fuzz HARNESS LO HI
[--device cuda|cpu]`` runs one (:mod:`.__main__`; ``--all`` runs every
one). ``README.md`` beside this file has the table of pairs and the
seeds cleared.
"""

from __future__ import annotations

import importlib
import time
import traceback

#: the harnesses in the order ``--all`` runs them
HARNESSES = ("parity", "rolling", "wire", "grid", "eval", "resample", "l3",
             "group", "search", "pipeline", "parallel", "refdiff")


def harness(name: str):
    """The harness module ``name`` (one of :data:`HARNESSES`)."""
    if name not in HARNESSES:
        raise ValueError(f"unknown harness {name!r}; expected one of "
                         f"{HARNESSES}")
    return importlib.import_module(f".{name}", __name__)


def device_of(device=None):
    """The device a harness runs on: the card unless ``device`` names
    another; raises without a card (``pipeline.resolve_device``)."""
    from ..pipeline import resolve_device

    return resolve_device(device)


def sweep(name: str, seeds, one, every: int = 20) -> list:
    """``one(seed)`` for every seed of ``seeds``: prints each failed seed
    (an AssertionError) or crashed one (any other error), a progress line
    every ``every`` seeds, and last ``DONE n seeds, k failures: [...]``;
    returns the failed seeds."""
    seeds = list(seeds)
    fails = []
    t0 = time.perf_counter()
    for i, seed in enumerate(seeds):
        try:
            one(seed)
        except AssertionError as e:
            fails.append(seed)
            print(f"SEED {seed} FAILED:\n{str(e)[:600]}\n", flush=True)
        except Exception as e:
            fails.append(seed)
            print(f"SEED {seed} CRASHED: {e!r}", flush=True)
            traceback.print_exc()
        if (i + 1) % every == 0:
            print(f"...{i + 1} {name} seeds done, {len(fails)} failures "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"DONE {len(seeds)} seeds, {len(fails)} failures: {fails}",
          flush=True)
    return fails
