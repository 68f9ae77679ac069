"""Reference-differential fuzz (``tools/fuzz/fuzz_refdiff.py``): the
reference's own code, run on the port's polars shim (:mod:`..refdiff`),
against the port.

* seeds below 100k: the reference's ``cal_*`` kernels against the port's
  f64 oracle on a day;
* from 100k: the reference's ``Factor.ic_test``/``group_test`` against
  the port's :class:`..factor.Factor` on ``device``;
* from 200k: the reference's ``cal_final_exposure`` against the port's
  (16 configurations), and on every third seed the reference's
  incremental driver against the port's with a cache resume.

The reference tree is the harness's (``REFDIFF_REFERENCE_DIR``, else its
default mount point), hash-pinned. Without it the harness skips, loudly.
``tree=`` (``--tree PATH``) runs on another tree, unpinned, such as the
stand-in ``tests/fixtures/refdiff_torch/``; seeds of a tier whose file
the tree lacks are skipped, loudly.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

from . import scenarios

#: the reference files each tier executes
TIER_FILES = {
    "day": ("MinuteFrequentFactorCalculateMethodsCICC.py",),
    "eval": ("Factor.py",),
    "final": ("Factor.py", "MinuteFrequentFactorCICC.py"),
}


@contextlib.contextmanager
def on_tree(tree):
    """The port's refdiff harness pointed at ``tree`` (unpinned) for the
    block; None leaves it on its own tree."""
    from ..refdiff import harness as h

    if tree is None:
        yield h
        return
    saved = (h.REFERENCE_DIR, h._ref_kernels_mod, h._ref_factor_mod,
             os.environ.get("REFDIFF_ALLOW_UNPINNED"))
    h.REFERENCE_DIR = str(tree)
    h._ref_kernels_mod = h._ref_factor_mod = None
    os.environ["REFDIFF_ALLOW_UNPINNED"] = "1"
    try:
        yield h
    finally:
        h.REFERENCE_DIR, h._ref_kernels_mod, h._ref_factor_mod = saved[:3]
        if saved[3] is None:
            os.environ.pop("REFDIFF_ALLOW_UNPINNED", None)
        else:
            os.environ["REFDIFF_ALLOW_UNPINNED"] = saved[3]


def check_case(seed: int, dev, h) -> None:
    tier, kw = scenarios.refdiff_case(seed)
    if tier == "final":
        mism = h.compare_final_exposure(rng_seed=seed, device=dev,
                                        **kw["final"])
        if not mism and kw["pipeline"] is not None:
            with tempfile.TemporaryDirectory() as td:
                mism = h.compare_pipeline(td, seed=seed, device=dev,
                                          **kw["pipeline"])
    elif tier == "eval":
        mism = h.compare_eval(rng_seed=seed, device=dev, **kw)
    else:
        mism = h.compare_day(kw["day"])
    assert not mism, f"{len(mism)} mismatches:\n" + "\n".join(
        f"    {m}" for m in mism[:5])


def run(lo: int, hi: int, device="cuda", tree=None):
    from . import device_of, sweep

    dev = device_of(device)
    with on_tree(tree) as h:
        root = h.REFERENCE_DIR
        missing = {t: [f for f in fs
                       if not os.path.exists(os.path.join(root, f))]
                   for t, fs in TIER_FILES.items()}
        if all(missing.values()):
            print(f"refdiff: SKIPPED [{lo}, {hi}): the reference tree "
                  f"{root} is absent (no reference code to diff against; "
                  "--tree PATH names another)", flush=True)
            return sweep("refdiff", (), None)
        seeds = [s for s in range(lo, hi)
                 if not missing[scenarios.refdiff_case(s)[0]]]
        if len(seeds) < hi - lo:
            print(f"refdiff: SKIPPED {hi - lo - len(seeds)} seeds whose "
                  f"tier's files {root} lacks: "
                  f"{ {t: m for t, m in missing.items() if m} }",
                  flush=True)
        return sweep("refdiff", seeds, lambda s: check_case(s, dev, h),
                     every=10)
