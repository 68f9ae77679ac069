"""Parity fuzz: the port's 58 factors on a device against the f64 oracle
(:mod:`..oracle`) on adversarial days, under the parity suite's
comparator (:mod:`.comparator`).

Seed N is the JAX harness's seed N (``tools/fuzz/fuzz_parity.py``,
:func:`.scenarios.parity_case`): below 10k one day of the historical
shape, from 10k wide day shapes, from 31k a batched multiday branch a
third of the time, from 32k 40-120 code universes. One comparison serves
a day and a batch of days, so a policy fix cannot reach one and miss the
other.
"""

from __future__ import annotations

import numpy as np

from . import comparator as C
from . import scenarios

BETA_Z = ("mmt_ols_qrs", "mmt_ols_beta_zscore_last")


def compare_days(days, label, noisy=False, device="cpu", session=None,
                 rolling_impl=None, judge=None):
    """Long-format days, gridded on their union of codes and batched on a
    leading axis, through the port on ``device`` against a multi-date
    oracle frame, cell by cell, the single-day comparator applied per
    date (the doc_pdf* rank is per day on both sides); raises
    AssertionError listing the failures. ``judge`` replaces
    :func:`.comparator._check_cell` (same signature).

    The degenerate-beta skip set is keyed by the same ``np.datetime64``
    objects the cell loop uses: a pandas groupby key (``pd.Timestamp``)
    compares equal to them but does not hash equal in a set."""
    import pandas as pd

    from ..data.minute import grid_day
    from ..models import factor_names
    from ..oracle import compute_oracle
    from ..pipeline import compute_batch

    judge = judge or C._check_cell
    dfs = [pd.DataFrame(d) for d in days]
    df = pd.concat(dfs)
    oracle = compute_oracle(df, session=session).set_index(["code", "date"])
    beta_deg = set()
    beta_ns = {}
    for day, sub in zip(days, dfs):
        skip, ns = C._degenerate_beta_codes(sub, session=session)
        d = day["date"][0]
        beta_deg |= {(c, d) for c in skip}
        beta_ns.update({(c, d): v for c, v in ns.items()})
    union = np.unique(np.concatenate([d["code"] for d in days]))
    grids = [grid_day(d["code"], d["time"], d["open"], d["high"],
                      d["low"], d["close"], d["volume"], codes=union,
                      session=session)
             for d in days]
    codes = grids[0].codes
    out = compute_batch(np.stack([g.bars for g in grids]),
                        np.stack([g.mask for g in grids]), device=device,
                        session=session, rolling_impl=rolling_impl)
    out = dict(zip(factor_names(), out.cpu().numpy()))
    dates = [d["date"][0] for d in days]
    failures: list = []
    pdf_acc = {d: C._lazy(lambda d=d: C._doc_pdf_acceptable(
        df[df.date == d], session=session, device=device)) for d in dates}
    for name in factor_names():
        assert out[name].shape == (len(days), len(codes))
        for di, d in enumerate(dates):
            cell = label if len(days) == 1 else f"{label}d{di}"
            for ti, code in enumerate(codes):
                if name in BETA_Z and (code, d) in beta_deg:
                    continue  # z-score of a sub-noise beta spread
                key = (code, d)
                in_oracle = key in oracle.index
                ov = oracle.loc[key, name] if in_oracle else np.nan
                aux = ({k: oracle.loc[key, k]
                        for k in ("shape_kurt", "shape_kurtVol")}
                       if in_oracle else {})
                aux["beta_num_scale"] = beta_ns.get(key)
                judge(cell, name, code, ov, out[name][di, ti], noisy,
                      failures, aux, pdf_acc[d])
    assert not failures, "\n".join(failures[:40]) + \
        f"\n({len(failures)} total)"


def check_seed(seed: int, device="cpu", judge=None) -> None:
    """Parity seed ``seed`` on ``device`` (noisy, as the JAX harness runs
    every seed); raises AssertionError on a failed cell."""
    compare_days(scenarios.parity_case(seed), f"fuzz{seed}", noisy=True,
                 device=device, judge=judge)


def check_pinned(seed: int, device="cpu", judge=None) -> None:
    """A seed the parity suite pins, as the suite runs it: the kitchen
    sink's seeds on its day, the boundary seeds on the historical shape,
    the wide seeds through the wide runner."""
    if seed in scenarios.KITCHEN_SINK_SEEDS:
        compare_days([scenarios.kitchen_sink_day(seed)], f"sink{seed}",
                     noisy=True, device=device, judge=judge)
    else:
        check_seed(seed, device=device, judge=judge)


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    dev = device_of(device)
    return sweep("parity", range(lo, hi), lambda s: check_seed(s, dev),
                 every=10)


def run_pinned(device="cuda"):
    """The parity suite's pinned seeds (:data:`.scenarios.PINNED_SEEDS`)
    through ``device``, each as the suite runs it."""
    from . import device_of, sweep

    dev = device_of(device)
    return sweep("pinned", scenarios.PINNED_SEEDS,
                 lambda s: check_pinned(s, dev), every=10)
