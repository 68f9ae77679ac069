"""A stand-in for the reference's kernel module, for the tests of the
port's ``backend='polars'`` and for ``chip_smoke.py`` phase 18.

It holds three ``cal_<name>(df)`` functions in the reference's calling
convention (a day's long-format frame in, one row per (code, date) group
out, the value in a column named after the factor): the three factors of
``tests/fixtures/refdiff_snapshot.json``. They are written in the polars
subset that the refdiff shim interprets and are transcribed from the
port's ``oracle/kernels.py``, not from the reference's own text. Their
bytes match no audited pin, so a harness executes this file only with
``REFDIFF_ALLOW_UNPINNED=1``.
"""

import polars as pl

#: cn_ashare_240's first afternoon bar and its last bar (``markets``'
#: ``T_PM_OPEN`` and ``T_PM_CLOSE``)
T_PM_OPEN, T_PM_CLOSE = 130000000, 145900000


def cal_vol_return1min(df):
    """The sample std (ddof 1) of the minute returns close / open - 1."""
    return (df.with_columns((pl.col("close") / pl.col("open") - 1)
                            .alias("ret"))
            .group_by(["code", "date"])
            .agg(pl.col("ret").std().alias("vol_return1min")))


def cal_mmt_pm(df):
    """The afternoon's return: the last sentinel bar's close over the
    first one's open; a group with neither sentinel bar is absent."""
    return (df.filter((pl.col("time") == T_PM_OPEN)
                      | (pl.col("time") == T_PM_CLOSE))
            .group_by(["code", "date"])
            .agg((pl.col("close").last() / pl.col("open").first())
                 .alias("mmt_pm")))


def cal_doc_pdf60(df):
    """The first whole-frame rank of the end-of-day return at which a
    group's cumulative volume share, walked in ascending rank, passes
    0.6; shares of tied ranks are summed first."""
    keys = ["code", "date"]
    return (df.with_columns(
                (pl.col("close").last().over(keys) / pl.col("close"))
                .alias("eod_ret"),
                (pl.col("volume") / pl.col("volume").sum().over(keys))
                .alias("vol_share"))
            .with_columns(pl.col("eod_ret").rank().alias("grank"))
            .group_by(["code", "date", "grank"])
            .agg(pl.col("vol_share").sum())
            .sort(["code", "date", "grank"])
            .with_columns(pl.col("vol_share").cum_sum().over(keys)
                          .alias("cum_share"))
            .filter(pl.col("cum_share") > 0.6)
            .group_by(keys)
            .agg(pl.col("grank").first().alias("doc_pdf60")))
