"""Factor-evaluation fuzz (``tools/fuzz/fuzz_l3.py``) on a device:
``Factor.ic_test`` against pandas/scipy over random ragged panels (NaNs,
codes missing from the PV data, short histories, ties) — forward N-day
compounded returns over each code's own trading days, per-date Pearson
and Spearman, their means and the ICIR — and ``Factor.group_test``
running clean with finite output across its parameters.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from . import scenarios


def write_pv(pv, path) -> None:
    """The daily PV frame as the parquet file the evaluation reads."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({
        "code": pa.array(pv["code"]),
        "date": pa.array(pv["date"].to_numpy().astype("datetime64[D]")),
        "pct_change": pa.array(pv["pct_change"]),
        "tmc": pa.array(pv["tmc"]), "cmc": pa.array(pv["cmc"])}), path)


def exposure_factor(exp, dev):
    from ..factor import Factor

    return Factor("toy", device=dev).set_exposure(
        exp["code"].to_numpy(object),
        exp["date"].to_numpy().astype("datetime64[D]"),
        exp["v"].to_numpy(np.float32))


def check_case(seed: int, dev, tmp: str) -> None:
    import scipy.stats

    c = scenarios.l3_case(seed)
    pv, exp, N = c["pv"], c["exp"], c["future_days"]
    pv_path = os.path.join(tmp, f"pv{seed}.parquet")
    write_pv(pv, pv_path)
    f = exposure_factor(exp, dev)
    f.ic_test(future_days=N, plot=False, daily_pv_path=pv_path)
    pvs = pv.sort_values(["code", "date"]).copy()
    fwd = []
    for _, g in pvs.groupby("code"):
        p = g["pct_change"].to_numpy()
        for i in range(len(g)):
            fwd.append(np.prod(1 + p[i + 1:i + N + 1]) - 1
                       if i + N < len(g) else np.nan)
    pvs["fwd"] = fwd
    j = exp.merge(pvs[["code", "date", "fwd"]], on=["code", "date"],
                  how="left").dropna(subset=["v", "fwd"])
    ics, rics = [], []
    for _, g in j.groupby("date"):
        if len(g) < 2 or g["v"].std() == 0 or g["fwd"].std() == 0:
            continue
        ic = scipy.stats.pearsonr(g["v"], g["fwd"])[0]
        ric = scipy.stats.spearmanr(g["v"], g["fwd"])[0]
        if np.isfinite(ic):
            ics.append(ic)
        if np.isfinite(ric):
            rics.append(ric)
    if ics:
        assert abs(f.IC - np.mean(ics)) < 5e-4, (f.IC, np.mean(ics))
        assert abs(f.rank_IC - np.mean(rics)) < 5e-4, \
            (f.rank_IC, np.mean(rics))
        icir = np.mean(ics) / np.std(ics, ddof=1) if len(ics) > 1 else None
        if icir is not None and np.isfinite(icir):
            assert abs(f.ICIR - icir) < 5e-3 * max(1, abs(icir)), \
                (f.ICIR, icir)
    else:
        assert f.IC is None or np.isnan(f.IC), f.IC
    g = f.group_test(frequency=c["frequency"],
                     weight_param=c["weight_param"],
                     group_num=c["group_num"], plot=False, return_df=True,
                     daily_pv_path=pv_path)
    assert g is None or np.isfinite(g["cum_return"]).any() or \
        len(g["period"]) == 0


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    dev = device_of(device)
    with tempfile.TemporaryDirectory() as tmp:
        return sweep("l3", range(lo, hi), lambda s: check_case(s, dev, tmp),
                     every=25)
