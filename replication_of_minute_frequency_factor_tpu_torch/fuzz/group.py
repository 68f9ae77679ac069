"""Group-test fuzz (``tools/fuzz/fuzz_group.py``) on a device:
``Factor.group_test``'s full value chain against a pandas oracle of the
reference's chain — per-date polars qcut of the exposure rows, per
(code, period) compounded return with the last row's group and caps, a
one-period lag per code, weighted group means (null weights drop from
both sums), every (period, group) value and no extra ones.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from . import scenarios
from .eval import polars_qcut
from .l3 import exposure_factor, write_pv


def oracle(exp, pv, K, freq, wparam):
    """``{(period, group): return}`` of the reference's chain."""
    from ..frames import period_start

    e = exp.copy()
    e["date"] = e["date"].to_numpy().astype("datetime64[D]")
    e["grp"] = -1
    for _, g in e.groupby("date"):
        vals = g["v"].to_numpy(np.float32).astype(np.float64)
        ok = np.isfinite(vals)
        labs = np.full(len(vals), -1)
        if ok.any():
            labs[ok] = polars_qcut(vals[ok], K)
        e.loc[g.index, "grp"] = labs
    pvo = pv.copy()
    pvo["date"] = pvo["date"].to_numpy().astype("datetime64[D]")
    j = e[["code", "date", "grp"]].merge(
        pvo[["code", "date", "pct_change", "tmc", "cmc"]],
        on=["code", "date"], how="left")
    j["period"] = period_start(
        j["date"].to_numpy().astype("datetime64[D]"), freq)
    # positional last (the reference's .last()); pandas' 'last' skips NaN
    plast = lambda s: s.iloc[-1] if len(s) else np.nan  # noqa: E731
    agg = j.sort_values("date").groupby(["code", "period"]).agg(
        ret=("pct_change", lambda s: np.prod(1 + s.dropna()) - 1),
        grp=("grp", plast), tmc=("tmc", plast), cmc=("cmc", plast),
    ).reset_index()
    agg = agg.sort_values(["code", "period"])
    for col in ("grp", "tmc", "cmc"):
        agg[col] = agg.groupby("code")[col].shift(1)
    agg = agg[agg["grp"].notna() & (agg["grp"] >= 0)]

    def wmean(g):
        if wparam is None:
            return float(g["ret"].mean())
        ok = g[wparam].notna()
        den = g.loc[ok, wparam].sum()
        if den == 0:
            return 0.0
        return float((g.loc[ok, "ret"] * g.loc[ok, wparam]).sum() / den)

    want = agg.groupby(["period", "grp"]).apply(wmean, include_groups=False)
    return {(np.datetime64(p, "D"), int(gl)): v for (p, gl), v in
            want.items()}


def check_case(seed: int, dev, tmp: str) -> None:
    c = scenarios.group_case(seed)
    pv, exp, K = c["pv"], c["exp"], c["group_num"]
    freq, wparam = c["frequency"], c["weight_param"]
    pv_path = os.path.join(tmp, f"pv{seed}.parquet")
    write_pv(pv, pv_path)
    got = exposure_factor(exp, dev).group_test(
        frequency=freq, weight_param=wparam, group_num=K, plot=False,
        return_df=True, daily_pv_path=pv_path)
    want = oracle(exp, pv, K, freq, wparam)
    periods, rm = got["period"], got["group_return"]
    for (p, gl), wv in want.items():
        pi = np.searchsorted(periods, p)
        assert pi < len(periods) and periods[pi] == p, (p, periods)
        gv = rm[pi, gl]
        assert np.isclose(gv, wv, rtol=2e-4, atol=1e-6), (p, gl, gv, wv)
    for pi, p in enumerate(periods):
        for gl in range(K):
            if np.isfinite(rm[pi, gl]):
                assert (p, gl) in want, ("extra", p, gl, rm[pi, gl])


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    dev = device_of(device)
    with tempfile.TemporaryDirectory() as tmp:
        return sweep("group", range(lo, hi), lambda s: check_case(s, dev, tmp))
