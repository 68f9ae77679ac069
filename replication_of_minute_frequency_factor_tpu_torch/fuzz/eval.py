"""Evaluation fuzz (``tools/fuzz/fuzz_eval.py``) on a device:
``eval_ops.ic_series`` against scipy's Pearson and Spearman per date,
``eval_ops.qcut_labels`` against polars' ``qcut(allow_duplicates=True)``
semantics (duplicate breaks kept: a value takes the first bin whose
break it does not exceed), and ``frames.forward_returns`` against the
naive compounded product over each code's own next rows.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scenarios


def polars_qcut(xs, k):
    """Labels of ``xs`` in ``k`` quantile bins, duplicate breaks kept."""
    breaks = np.quantile(xs, [(i + 1) / k for i in range(k - 1)])
    return np.searchsorted(breaks, xs, side="left")


def naive_forward_returns(code, date, pct, n):
    """``prod(1 + pct)`` over each row's code's next ``n`` rows by date,
    minus 1; NaN past the code's last rows or over a missing pct."""
    out = np.full(len(code), np.nan)
    for c in np.unique(code):
        rows = sorted(np.flatnonzero(code == c), key=lambda i: date[i])
        for j, i in enumerate(rows):
            nxt = rows[j + 1:j + 1 + n]
            if len(nxt) == n and not np.isnan(pct[nxt]).any():
                out[i] = np.prod(1.0 + pct[nxt]) - 1.0
    return out


def check_case(seed: int, dev) -> None:
    import scipy.stats

    from .. import eval_ops, frames

    c = scenarios.eval_case(seed)
    x, y, m, k = c["x"], c["y"], c["m"], c["k"]
    n_d = x.shape[0]

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ic, ric = eval_ops.ic_series(on(np.nan_to_num(x)), on(np.nan_to_num(y)),
                                 on(m))
    ic, ric = ic.cpu().numpy(), ric.cpu().numpy()
    for d in range(n_d):
        xs, ys = x[d, m[d]], y[d, m[d]]
        if len(xs) < 2 or xs.std() == 0 or ys.std() == 0:
            assert np.isnan(ic[d]), (seed, d, "expected NaN ic", ic[d])
            continue
        w_ic = scipy.stats.pearsonr(xs, ys)[0]
        w_rk = scipy.stats.spearmanr(xs, ys)[0]
        if np.isnan(w_rk):  # constant ranks
            assert np.isnan(ric[d]), (seed, d)
        else:
            assert abs(ric[d] - w_rk) < 5e-5, (seed, d, ric[d], w_rk)
        assert abs(ic[d] - w_ic) < 5e-5, (seed, d, ic[d], w_ic)
    labels = eval_ops.qcut_labels(on(np.nan_to_num(x)), on(m), k)
    labels = labels.cpu().numpy()
    for d in range(n_d):
        xs = x[d, m[d]].astype(np.float64)
        if len(xs) == 0:
            continue
        np.testing.assert_array_equal(labels[d][m[d]], polars_qcut(xs, k),
                                      err_msg=f"{seed}/{d}/k={k}")
        # invalid lanes carry a sentinel, never a bin label
        assert not np.isin(labels[d][~m[d]], np.arange(k)).any()
    got = frames.forward_returns(c["codes"], c["dates"], c["pct"], c["n"])
    want = naive_forward_returns(c["codes"], c["dates"], c["pct"], c["n"])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=f"{seed} forward_returns NaN")
    f = ~np.isnan(want)
    np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=1e-9,
                               err_msg=f"{seed} forward_returns")


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    dev = device_of(device)
    return sweep("eval", range(lo, hi), lambda s: check_case(s, dev),
                 every=50)
