"""The three reference chart types, headless-safe matplotlib.

Coverage bar (Factor.py:106-122), IC bar + cumulative line on twin axes
(:191-226), decile cumulative-return lines with percent formatting
(:322-347). Each renderer returns the Figure; pass ``save_path`` to write a
PNG without needing a display.

The port's copy of the JAX package's ``plotting.py``. matplotlib is
imported when a chart is drawn, not when the module is, so the package
and ``chip_smoke.py`` run on a machine without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, save_path: Optional[str]):
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig


def plot_coverage(dates, counts, factor_name: str,
                  save_path: Optional[str] = None):
    fig, ax = _pyplot().subplots(figsize=(12, 4))
    ax.bar(np.asarray(dates, "datetime64[D]").astype("datetime64[ns]"),
           counts, width=1.0, color="#4C72B0")
    ax.set_title(f"{factor_name} coverage")
    ax.set_ylabel("# non-NaN exposures")
    return _finish(fig, save_path)


def plot_ic(dates, ic, factor_name: str, stats: Optional[dict] = None,
            save_path: Optional[str] = None, label: str = "IC"):
    """Per-date IC bars (left axis) + cumulative line (right axis);
    ``label`` switches the series name (the reference's ``plot_variable``
    knob, Factor.py:131,196-208 — 'IC' or 'rank_IC')."""
    d = np.asarray(dates, "datetime64[D]").astype("datetime64[ns]")
    fig, ax = _pyplot().subplots(figsize=(12, 4))
    ax.bar(d, ic, width=1.0, color="#4C72B0", label=label)
    ax.set_ylabel(label)
    ax2 = ax.twinx()
    ax2.plot(d, np.cumsum(np.nan_to_num(ic)), color="#C44E52",
             label=f"cumulative {label}")
    ax2.set_ylabel(f"cumulative {label}")
    title = f"{factor_name} {label}"
    if stats:
        title += "  " + "  ".join(f"{k}={v:.4f}" for k, v in stats.items())
    ax.set_title(title)
    return _finish(fig, save_path)


def plot_group_returns(period_dates, cum_returns: np.ndarray,
                       factor_name: str,
                       labels: Optional[Sequence[str]] = None,
                       save_path: Optional[str] = None):
    """cum_returns: [periods, groups] cumulative return per decile."""
    from matplotlib.ticker import PercentFormatter

    d = np.asarray(period_dates, "datetime64[D]").astype("datetime64[ns]")
    fig, ax = _pyplot().subplots(figsize=(12, 5))
    g = cum_returns.shape[1]
    for j in range(g):
        ax.plot(d, cum_returns[:, j],
                label=labels[j] if labels else f"group {j}")
    ax.yaxis.set_major_formatter(PercentFormatter(xmax=1.0))
    ax.legend(loc="upper left", ncols=min(g, 5), fontsize=8)
    ax.set_title(f"{factor_name} group cumulative return")
    return _finish(fig, save_path)
