"""Resampler fuzz (``tools/fuzz/fuzz_resample.py``):
``MinFreqFactor.cal_final_exposure`` against pandas for every (mode,
frequency, method) over ragged, NaN-bearing panels. The resampler is host
numpy; ``device`` is the factor's (and only resolved).
"""

from __future__ import annotations

import numpy as np

from . import scenarios


def _oracle(df, mode, freq, method):
    """pandas rows ``(code, date, value)`` of one configuration: calendar
    windows start Monday / month start, labelled by their start, ddof 1;
    the days mode is a rolling window of ``freq`` rows, ddof 0, and its
    'o' a passthrough."""
    import pandas as pd

    want_rows = []
    for c, g in df.groupby("code"):
        g = g.sort_values("date").set_index("date")["value"]
        g.index = pd.to_datetime(g.index)
        if mode == "calendar":
            grp = g.groupby(pd.Grouper(freq="W-MON", label="left",
                                       closed="left") if freq == "week"
                            else pd.Grouper(freq="MS"))
            for period, s in grp:
                if not len(s):
                    continue
                if method == "o":
                    w = s.iloc[-1]
                elif method == "m":
                    w = s.mean()
                elif method == "z":
                    sd = s.std(ddof=1)
                    w = (s.iloc[-1] - s.mean()) / sd if sd > 0 else np.nan
                else:
                    w = s.std(ddof=1)
                want_rows.append((c, period, w))
        else:
            r = g.rolling(freq, min_periods=freq)
            if method == "o":
                w = g
            elif method == "m":
                w = r.mean()
            elif method == "z":
                w = (g - r.mean()) / r.std(ddof=0)
            else:
                w = r.std(ddof=0)
            for dt_, wv in w.items():
                want_rows.append((c, dt_, wv))
    want = pd.DataFrame(want_rows, columns=["code", "date", "w"])
    want["date"] = want["date"].dt.normalize()
    return want


def check_case(seed: int, dev) -> None:
    import pandas as pd

    from ..minfreq import MinFreqFactor

    c = scenarios.resample_case(seed)
    code, date, value = c["code"], c["date"], c["value"]
    # f64 once here: pandas on raw f32 loses the z-score's deviations to
    # cancellation; the port computes in f64 too
    df = pd.DataFrame({"code": code, "date": date,
                       "value": value.astype(np.float64)})
    for mode, freq in (("calendar", "week"), ("calendar", "month"),
                       ("days", c["days_window"])):
        for method in ("o", "m", "z", "std"):
            f = MinFreqFactor("toy", device=dev).set_exposure(code, date,
                                                              value)
            out = f.cal_final_exposure(freq, method=method,
                                       mode=mode).factor_exposure
            col = [k for k in out if k not in ("code", "date")][0]
            got = pd.DataFrame({k: out[k] for k in ("code", "date")}
                               | {"v": out[col]})
            want = _oracle(df, mode, freq, method)
            got["date"] = pd.to_datetime(got["date"])
            merged = got.merge(want, on=["code", "date"], how="outer",
                               indicator=True)
            if mode == "days":  # same grid: a full outer match
                bad = merged[merged._merge != "both"]
                if len(bad):
                    raise AssertionError(
                        f"{mode}/{freq}/{method}: row mismatch\n{bad.head()}")
            both = merged[merged._merge == "both"]
            a, b = both["v"].to_numpy(float), both["w"].to_numpy(float)
            ok = np.isclose(a, b, rtol=2e-4, atol=1e-5) | (
                np.isnan(a) & np.isnan(b))
            if not ok.all():
                i = np.flatnonzero(~ok)[0]
                raise AssertionError(
                    f"{mode}/{freq}/{method}: {both.iloc[i].to_dict()}")


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    dev = device_of(device)
    return sweep("resample", range(lo, hi), lambda s: check_case(s, dev))
