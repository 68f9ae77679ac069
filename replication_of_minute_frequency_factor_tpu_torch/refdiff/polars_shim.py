"""A minimal polars-API interpreter, enough to run the reference tree.

The port's copy of the repo's ``tools/refdiff/polars_shim.py`` (numpy
only; ``SEMANTIC_PINS`` and the null-vs-NaN validity masks are kept
verbatim, and the tests hold the two copies equal bit for bit).

The reference (`Factor.py`, `MinuteFrequentFactorCICC.py`,
`MinuteFrequentFactorCalculateMethodsCICC.py`) is pure polars. Where no
polars can be installed, this module implements the exact expression-API
subset those files use, backed by numpy (f64), and is made resolvable as
``polars`` by :mod:`.harness` only while a reference module is being
imported (the ``sys.modules`` entry is restored right after exec).
The reference's own expression graphs then execute unmodified — a true
differential against our reimplementations' *structure* (columns,
filters, operation order, quirks Q1-Q7 of SURVEY.md §2.5).

What it cannot test: engine behaviors the expression text doesn't spell
out. Those are pinned here, once, in ``SEMANTIC_PINS`` — each entry
states the behavior this shim implements and the polars documentation it
was pinned against. A wrong pin is a shared-oracle risk, but an audited,
single-location one.

Null vs NaN: polars distinguishes them; so does this shim. A ``Series``
carries a validity mask; NaN is an ordinary float value.
"""

from __future__ import annotations

import numpy as np

SEMANTIC_PINS = {
    "group_order": (
        "group_by emits groups in ascending key order. Real polars order "
        "is nondeterministic unless maintain_order=True (then it is "
        "first-appearance). Affects doc_pdf* cum_sum (quirk Q7) and "
        "mmt_paratio last-minus-first; ascending == the repo-wide Q7 pin "
        "(oracle/kernels.py). For time-sorted input, ascending and "
        "first-appearance coincide for mmt_paratio (AM session sorts and "
        "appears first)."),
    "sum_empty": "sum of an empty/all-null selection is 0 (polars sum).",
    "product_empty": "product of empty/all-null selection is 1.",
    "mean_empty": "mean/min/max/first/last of empty selection is null.",
    "std_small_n": (
        "std/var with n - ddof <= 0 valid observations is null (so a "
        "following fill_null applies; vol_upVol relies on this)."),
    "skew_kurt": (
        "skew is biased Fisher-Pearson g1, kurtosis is biased Fisher "
        "excess g2 (polars defaults, bias=True); zero variance yields "
        "NaN (a value, NOT null — fill_null does not touch it); empty "
        "selection is null."),
    "agg_skip_null": (
        "sum/mean/std/var/skew/kurtosis/product/min/max skip nulls; NaN "
        "participates and propagates (polars treats NaN as a float "
        "value)."),
    "corr_pairwise": (
        "pl.corr/pl.cov use pairwise-complete observations: rows where "
        "both sides are non-null AND (corr only) non-NaN are kept; corr "
        "with <2 pairs is NaN; matches oracle/stats.py pearson. Real "
        "polars likely PROPAGATES a NaN input instead — unreachable in "
        "the reference's usage (every corr input is built from positive "
        "prices, or zero-volume rows are pre-filtered), so the drop "
        "semantics are never exercised differently, but an auditor "
        "should know the shim is oracle-aligned here, not "
        "polars-verified."),
    "total_order": (
        "top_k/bottom_k/sort/rank use polars' total float order: NaN is "
        "greater than +inf; nulls are dropped by top_k/bottom_k, sorted "
        "first by Expr.sort(), ranked null by rank()."),
    "when_null_cond": (
        "a null condition in when/then/otherwise selects the otherwise "
        "branch (null is not 'true')."),
    "pct_change": (
        "x.pct_change() = x / x.shift(1) - 1 with null propagation from "
        "the shifted null (leading element null); 0/0 is NaN, x/0 is "
        "±inf (float semantics, no error)."),
    "cast_int": "cast to integer truncates toward zero (polars cast).",
    "true_division": "/ always yields float, including int/int.",
    "filter_null": "filter drops rows whose predicate is null.",
    "first_last_nulls": "first()/last() include nulls (positional).",
    "cum_sum_null": "cum_sum leaves nulls null and skips them in the "
                    "running total.",
    "rank": "rank() is method='average', ascending (polars default).",
    "len": "pl.len() counts rows including nulls.",
    "qcut_nan": (
        "qcut buckets a NaN value to null (excluded), and computes "
        "breakpoints from finite values only. UNVERIFIABLE against real "
        "polars here: under polars' total float order a NaN could "
        "plausibly land in the TOP bin instead, which would mean the "
        "reference's group_test (which, unlike its ic_test, never "
        "filters NaN exposures — Factor.py:280-292) puts NaN-exposure "
        "stocks into the best-factor bucket. The repo pins the "
        "exclude-NaN reading (eval_ops.qcut_labels); revisit on real "
        "polars."),
    "align_left": (
        "concat(how='align_left') joins every later frame onto the "
        "FIRST frame's rows on the automatically-determined common "
        "columns, output sorted ascending by those columns — so "
        "group_test's period aggregation runs over the exposure grid's "
        "(code, date) rows, and '.last()' picks the last EXPOSURE date "
        "of each period, not the last trading row (quirk Q10)."),
    "constant_window": (
        "var/std/cov/corr anchor the series at its first observation "
        "before the moment pass, so a constant window yields EXACTLY "
        "zero variance and the reference's degenerate-branch guards "
        "(when(var_x*var_y != 0) in mmt_ols_*; corr denominators) take "
        "the degenerate path (null / NaN). UNVERIFIABLE against real "
        "polars in this container: polars' two-pass variance yields "
        "exact 0 on a constant window only when the f64 mean rounds "
        "exactly, so on e.g. a limit-locked stock real polars may emit "
        "cov^2/(var_x*var_y) ~ 1.0 (shared rounding noise) where this "
        "pin yields 0.0 via fill_null. The repo pins the degenerate "
        "reading everywhere (oracle/stats.py anchored pearson; JAX "
        "masked ops); revisit if a real-polars environment becomes "
        "available."),
}

# The two pins flagged UNVERIFIABLE above are parameterized so their
# blast radius can be measured instead of trusted: the differential can
# run under BOTH readings. The port's single registry is its pins.py —
# the shim consults it lazily so shim and port can never drift apart;
# flip THERE if a real-polars run ever contradicts a default.


def _pin_reading(name):
    from .. import pins

    return pins.reading(name)


def pin_reading(**overrides):
    """Context manager: temporarily select alternative pin readings
    (``with pin_reading(constant_window="noise"): ...``). Delegates to
    the one registry in the port's ``pins.pinned`` — readings validated
    there."""
    from .. import pins

    return pins.pinned(**overrides)


# --------------------------------------------------------------------------
# Series: values + validity
# --------------------------------------------------------------------------

class Series:
    __slots__ = ("v", "ok")

    def __init__(self, v, ok=None):
        self.v = np.asarray(v)
        if ok is None:
            ok = np.ones(self.v.shape[0], dtype=bool)
        self.ok = np.asarray(ok, dtype=bool)

    def __len__(self):
        return self.v.shape[0]

    @staticmethod
    def scalar(value, valid=True):
        return Series(np.asarray([value]), np.asarray([bool(valid)]))

    def fl(self):
        """Float64 view with NaN at invalid slots."""
        v = self.v.astype(np.float64, copy=True)
        v[~self.ok] = np.nan
        return v

    def to_numpy(self):
        """Match polars Series.to_numpy: nulls become NaN for numerics."""
        return self.fl() if self.v.dtype.kind in "iuf" else self.v

    # eager Series API (the reference uses these on extracted columns,
    # e.g. ic_df['IC'].mean() / .std() / .cum_sum(), Factor.py:187-207)
    def __array__(self, dtype=None, copy=None):
        arr = self.to_numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __iter__(self):
        return iter(self.to_numpy())

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Series(self.v[i], self.ok[i])
        return self.v[i] if self.ok[i] else None

    def mean(self):
        s = _agg_mean(self)
        return float(s.v[0]) if s.ok[0] else None

    def std(self, ddof=1):
        s = _agg_std(self, ddof)
        return float(s.v[0]) if s.ok[0] else None

    def sum(self):
        return _agg_sum(self).v[0]

    def cum_sum(self):
        filled = np.where(self.ok, self.fl(), 0.0)
        out = np.cumsum(filled)
        out[~self.ok] = np.nan
        return Series(out, self.ok.copy())

    def cum_prod(self):
        filled = np.where(self.ok, self.fl(), 1.0)
        out = np.cumprod(filled)
        out[~self.ok] = np.nan
        return Series(out, self.ok.copy())

    def unique(self):
        return Series(np.unique(self.v[self.ok]))

    def max(self):
        v = self.v[self.ok]
        return v.max() if v.size else None

    def min(self):
        v = self.v[self.ok]
        return v.min() if v.size else None

    def sort(self, descending=False):
        vv = np.sort(self.v[self.ok], kind="stable")
        if descending:
            vv = vv[::-1]
        nulls = int((~self.ok).sum())
        if nulls:
            return Series(np.concatenate([self.v[~self.ok], vv]),
                          np.r_[np.zeros(nulls, bool),
                                np.ones(vv.size, bool)])
        return Series(vv)

    def __add__(self, other):
        if isinstance(other, Series):
            return _binop(self, other, "add")
        return _binop(self, Series.scalar(other), "add")

    def __sub__(self, other):
        if isinstance(other, Series):
            return _binop(self, other, "sub")
        return _binop(self, Series.scalar(other), "sub")

    def __truediv__(self, other):
        if isinstance(other, Series):
            return _binop(self, other, "truediv")
        return _binop(self, Series.scalar(other), "truediv")

    def __mul__(self, other):
        if isinstance(other, Series):
            return _binop(self, other, "mul")
        return _binop(self, Series.scalar(other), "mul")


def _broadcast(a: Series, b: Series):
    if len(a) == len(b):
        return a, b
    if len(a) == 1:
        return Series(np.repeat(a.v, len(b)), np.repeat(a.ok, len(b))), b
    if len(b) == 1:
        return a, Series(np.repeat(b.v, len(a)), np.repeat(b.ok, len(a)))
    raise ValueError(f"length mismatch {len(a)} vs {len(b)}")


def _is_int(arr):
    return arr.dtype.kind in "iu"


def _binop(a: Series, b: Series, op: str) -> Series:
    a, b = _broadcast(a, b)
    ok = a.ok & b.ok
    av, bv = a.v, b.v
    with np.errstate(all="ignore"):
        if op == "truediv":
            out = av.astype(np.float64) / bv.astype(np.float64)
        elif op == "floordiv":
            out = av // bv
        elif op == "mod":
            out = av % bv
        elif op == "add":
            out = av + bv
        elif op == "sub":
            out = av - bv
        elif op == "mul":
            out = av * bv
        elif op == "pow":
            out = av.astype(np.float64) ** bv.astype(np.float64)
        elif op in ("eq", "ne", "lt", "le", "gt", "ge"):
            fn = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
                  "le": np.less_equal, "gt": np.greater,
                  "ge": np.greater_equal}[op]
            out = fn(av, bv)
        elif op == "and":
            out = av.astype(bool) & bv.astype(bool)
        elif op == "or":
            out = av.astype(bool) | bv.astype(bool)
        else:  # pragma: no cover
            raise ValueError(op)
    return Series(out, ok)


# --------------------------------------------------------------------------
# Aggregations on Series (null-aware). Each returns a length-1 Series.
# --------------------------------------------------------------------------

def _valid(s: Series) -> np.ndarray:
    return s.v[s.ok]


def _agg_sum(s: Series) -> Series:
    v = _valid(s)
    if v.size == 0:
        zero = 0 if _is_int(s.v) else 0.0
        return Series.scalar(zero)
    return Series.scalar(v.sum())


def _agg_product(s: Series) -> Series:
    v = _valid(s)
    return Series.scalar(v.prod() if v.size else 1.0)


def _agg_mean(s: Series) -> Series:
    v = _valid(s)
    if v.size == 0:
        return Series.scalar(np.nan, valid=False)
    return Series.scalar(float(np.mean(v.astype(np.float64))))


def _anchor(v: np.ndarray) -> np.ndarray:
    """Shift a series to its first observation before a moment pass.

    Mathematically a no-op for var/cov/corr (shift invariance); makes a
    constant series produce *exactly* zero variance instead of f64
    rounding noise, so degenerate-branch guards like
    ``when(var_x * var_y != 0)`` (mmt_ols_*) take the degenerate path.
    PIN (``SEMANTIC_PINS['constant_window']``): real polars' behavior on
    a constant window is bit-level data-dependent (its two-pass variance
    yields exact 0 only when the mean rounds exactly); we pin the
    degenerate reading repo-wide (oracle/stats.py anchors identically).
    Under the alternative ``pins.READINGS['constant_window'] == 'noise'``
    reading this is the identity, exposing raw two-pass rounding.
    """
    if _pin_reading("constant_window") == "noise":
        return v
    return v - v[0] if v.size else v


def _agg_std(s: Series, ddof=1) -> Series:
    v = _valid(s).astype(np.float64)
    if v.size - ddof <= 0:
        return Series.scalar(np.nan, valid=False)
    with np.errstate(all="ignore"):
        return Series.scalar(float(np.std(_anchor(v), ddof=ddof)))


def _agg_var(s: Series, ddof=1) -> Series:
    v = _valid(s).astype(np.float64)
    if v.size - ddof <= 0:
        return Series.scalar(np.nan, valid=False)
    with np.errstate(all="ignore"):
        return Series.scalar(float(np.var(_anchor(v), ddof=ddof)))


def _agg_skew(s: Series) -> Series:
    v = _valid(s).astype(np.float64)
    if v.size == 0:
        return Series.scalar(np.nan, valid=False)
    m = v.mean()
    m2 = ((v - m) ** 2).mean()
    m3 = ((v - m) ** 3).mean()
    with np.errstate(all="ignore"):
        return Series.scalar(float(m3 / m2 ** 1.5))


def _agg_kurtosis(s: Series) -> Series:
    v = _valid(s).astype(np.float64)
    if v.size == 0:
        return Series.scalar(np.nan, valid=False)
    m = v.mean()
    m2 = ((v - m) ** 2).mean()
    m4 = ((v - m) ** 4).mean()
    with np.errstate(all="ignore"):
        return Series.scalar(float(m4 / (m2 * m2) - 3.0))


def _agg_first(s: Series) -> Series:
    if len(s) == 0:
        return Series.scalar(np.nan, valid=False)
    return Series(s.v[:1], s.ok[:1])


def _agg_last(s: Series) -> Series:
    if len(s) == 0:
        return Series.scalar(np.nan, valid=False)
    return Series(s.v[-1:], s.ok[-1:])


def _agg_min(s: Series) -> Series:
    v = _valid(s)
    if v.size == 0:
        return Series.scalar(np.nan, valid=False)
    return Series.scalar(v.min())


def _agg_max(s: Series) -> Series:
    v = _valid(s)
    if v.size == 0:
        return Series.scalar(np.nan, valid=False)
    return Series.scalar(v.max())


def _pairwise(a: Series, b: Series):
    a, b = _broadcast(a, b)
    ok = a.ok & b.ok
    return a.fl()[ok], b.fl()[ok]


def _corr2(a: Series, b: Series) -> Series:
    av, bv = _pairwise(a, b)
    keep = ~(np.isnan(av) | np.isnan(bv))
    av, bv = av[keep], bv[keep]
    if av.size < 2:
        return Series.scalar(np.nan)
    av, bv = _anchor(av), _anchor(bv)  # constant -> exactly-zero var -> NaN
    da, db = av - av.mean(), bv - bv.mean()
    with np.errstate(all="ignore"):
        r = (da * db).sum() / np.sqrt((da * da).sum() * (db * db).sum())
    return Series.scalar(float(r))


def _cov2(a: Series, b: Series, ddof=1) -> Series:
    av, bv = _pairwise(a, b)
    n = av.size
    if n - ddof <= 0:
        if n == 0:
            return Series.scalar(np.nan, valid=False)
        return Series.scalar(np.nan)
    av, bv = _anchor(av), _anchor(bv)
    with np.errstate(all="ignore"):
        c = ((av - av.mean()) * (bv - bv.mean())).sum() / (n - ddof)
    return Series.scalar(float(c))


# total float order (polars): NaN > +inf — numpy sort/argsort already
# place NaN last (greatest) for floats, so the identity suffices
def _order_key(v: np.ndarray) -> np.ndarray:
    return v


def _topk(s: Series, k: int, largest: bool) -> Series:
    v = _valid(s)
    srt = np.sort(_order_key(v), kind="stable")  # NaN last == greatest
    sel = srt[-k:] if largest else srt[:k]
    return Series(sel)


def _rank_avg(s: Series) -> Series:
    out = np.full(len(s), np.nan)
    v = s.fl()[s.ok]
    if v.size:
        order = np.argsort(_order_key(v), kind="stable")
        ranks = np.empty(v.size, dtype=np.float64)
        sorted_v = v[order]
        i = 0
        while i < v.size:
            j = i
            while (j + 1 < v.size
                   and (sorted_v[j + 1] == sorted_v[i]
                        or (np.isnan(sorted_v[j + 1])
                            and np.isnan(sorted_v[i])))):
                j += 1
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        out[s.ok] = ranks
    return Series(out, s.ok.copy())


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------

class Ctx:
    """One evaluation scope: named columns of equal height."""

    __slots__ = ("cols", "height")

    def __init__(self, cols: dict, height: int):
        self.cols = cols
        self.height = height

    def take(self, idx) -> "Ctx":
        cols = {k: Series(s.v[idx], s.ok[idx]) for k, s in self.cols.items()}
        n = int(np.asarray(idx).sum()) if np.asarray(idx).dtype == bool \
            else len(np.asarray(idx))
        return Ctx(cols, n)


def _to_expr(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    return lit(x)


class Expr:
    __slots__ = ("_ev", "_name")

    def __init__(self, ev, name="literal"):
        self._ev = ev
        self._name = name

    # -- operators ---------------------------------------------------------
    def _bin(self, other, op, rhs=False):
        o = _to_expr(other)
        a, b = (o, self) if rhs else (self, o)
        nm = a._name if isinstance(a, Expr) else self._name
        return Expr(lambda c: _binop(a._ev(c), b._ev(c), op), self._name
                    if not rhs else nm)

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return self._bin(o, "add", rhs=True)

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return self._bin(o, "sub", rhs=True)

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __rmul__(self, o):
        return self._bin(o, "mul", rhs=True)

    def __truediv__(self, o):
        return self._bin(o, "truediv")

    def __rtruediv__(self, o):
        return self._bin(o, "truediv", rhs=True)

    def __floordiv__(self, o):
        return self._bin(o, "floordiv")

    def __mod__(self, o):
        return self._bin(o, "mod")

    def __pow__(self, o):
        return self._bin(o, "pow")

    def __eq__(self, o):  # noqa: D105
        return self._bin(o, "eq")

    def __ne__(self, o):
        return self._bin(o, "ne")

    def __lt__(self, o):
        return self._bin(o, "lt")

    def __le__(self, o):
        return self._bin(o, "le")

    def __gt__(self, o):
        return self._bin(o, "gt")

    def __ge__(self, o):
        return self._bin(o, "ge")

    def __and__(self, o):
        return self._bin(o, "and")

    def __or__(self, o):
        return self._bin(o, "or")

    def __invert__(self):
        def ev(c):
            s = self._ev(c)
            return Series(~s.v.astype(bool), s.ok.copy())
        return Expr(ev, self._name)

    def __neg__(self):
        def ev(c):
            s = self._ev(c)
            return Series(-s.v, s.ok.copy())
        return Expr(ev, self._name)

    def __hash__(self):  # __eq__ is overloaded; keep Expr hashable
        return id(self)

    # -- naming / casting --------------------------------------------------
    def alias(self, name):
        return Expr(self._ev, name)

    def cast(self, dtype):
        def ev(c):
            s = self._ev(c)
            if dtype in _INT_DTYPES:
                if s.ok.all() and s.v.dtype.kind in "iuf":
                    return Series(
                        np.trunc(s.v).astype(np.int64) if s.v.dtype.kind
                        == "f" else s.v.astype(np.int64), s.ok.copy())
                # nulls present: keep float carrier, truncate values
                v = s.fl()
                t = np.where(np.isnan(v), v, np.trunc(v))
                return Series(t, s.ok.copy())
            if dtype in _FLOAT_DTYPES:
                return Series(s.v.astype(np.float64), s.ok.copy())
            if dtype in _STR_DTYPES:
                return Series(s.v.astype(str), s.ok.copy())
            raise NotImplementedError(f"cast to {dtype!r}")
        return Expr(ev, self._name)

    # -- elementwise -------------------------------------------------------
    def abs(self):
        def ev(c):
            s = self._ev(c)
            return Series(np.abs(s.v), s.ok.copy())
        return Expr(ev, self._name)

    def pow(self, p):
        return self.__pow__(p)

    def log(self):
        def ev(c):
            s = self._ev(c)
            with np.errstate(all="ignore"):
                return Series(np.log(s.v.astype(np.float64)), s.ok.copy())
        return Expr(ev, self._name)

    def exp(self):
        def ev(c):
            s = self._ev(c)
            with np.errstate(all="ignore"):
                return Series(np.exp(s.v.astype(np.float64)), s.ok.copy())
        return Expr(ev, self._name)

    def fill_null(self, value):
        def ev(c):
            s = self._ev(c)
            if s.ok.all():
                return s
            v = s.v.astype(np.float64, copy=True) \
                if s.v.dtype.kind in "iuf" else s.v.copy()
            v[~s.ok] = value
            return Series(v, np.ones(len(s), bool))
        return Expr(ev, self._name)

    def is_null(self):
        def ev(c):
            s = self._ev(c)
            return Series(~s.ok)
        return Expr(ev, self._name)

    def is_not_null(self):
        def ev(c):
            s = self._ev(c)
            return Series(s.ok.copy())
        return Expr(ev, self._name)

    def is_nan(self):
        def ev(c):
            s = self._ev(c)
            return Series(np.isnan(s.fl()), s.ok.copy())
        return Expr(ev, self._name)

    def is_in(self, values):
        vals = list(values)

        def ev(c):
            s = self._ev(c)
            return Series(np.isin(s.v, vals), s.ok.copy())
        return Expr(ev, self._name)

    def shift(self, n=1):
        def ev(c):
            s = self._ev(c)
            v = s.v.astype(np.float64, copy=True) \
                if s.v.dtype.kind in "iuf" else s.v.astype(object)
            out_v = np.empty_like(v)
            out_ok = np.zeros(len(s), bool)
            if n >= 0:
                out_v[n:] = v[:len(s) - n] if n else v
                out_ok[n:] = s.ok[:len(s) - n] if n else s.ok
                out_v[:n] = np.nan
            else:
                out_v[:n] = v[-n:]
                out_ok[:n] = s.ok[-n:]
                out_v[n:] = np.nan
            return Series(out_v, out_ok)
        return Expr(ev, self._name)

    def pct_change(self, n=1):
        return self / self.shift(n) - 1

    def cum_sum(self):
        def ev(c):
            s = self._ev(c)
            v = s.fl()
            filled = np.where(s.ok, v, 0.0)
            out = np.cumsum(filled)
            out[~s.ok] = np.nan
            return Series(out, s.ok.copy())
        return Expr(ev, self._name)

    def cum_prod(self):
        def ev(c):
            s = self._ev(c)
            v = s.fl()
            filled = np.where(s.ok, v, 1.0)
            out = np.cumprod(filled)
            out[~s.ok] = np.nan
            return Series(out, s.ok.copy())
        return Expr(ev, self._name)

    def rank(self, method="average"):
        if method != "average":
            raise NotImplementedError(method)

        def ev(c):
            return _rank_avg(self._ev(c))
        return Expr(ev, self._name)

    def rolling_mean(self, window_size, min_samples=None):
        return self._rolling_window(window_size, min_samples, "mean")

    def rolling_sum(self, window_size, min_samples=None):
        return self._rolling_window(window_size, min_samples, "sum")

    def rolling_std(self, window_size, min_samples=None, ddof=1):
        return self._rolling_window(window_size, min_samples, "std", ddof)

    def _rolling_window(self, w, min_samples, kind, ddof=1):
        mn = w if min_samples is None else min_samples

        def ev(c):
            s = self._ev(c)
            v = s.fl()
            n = len(s)
            out = np.full(n, np.nan)
            ok = np.zeros(n, bool)
            for i in range(n):
                win = v[max(0, i - w + 1):i + 1]
                winok = s.ok[max(0, i - w + 1):i + 1]
                vv = win[winok]  # nulls skipped inside the window
                # polars min_samples counts NON-NULL values in the
                # window, not slots (verified indirectly: the repo's
                # NaN-window nulling matches only under this reading)
                if vv.size < mn:
                    continue
                if kind == "sum":
                    out[i], ok[i] = vv.sum(), True
                elif kind == "mean":
                    out[i], ok[i] = vv.mean(), True
                elif kind == "std":
                    if vv.size - ddof > 0:
                        out[i], ok[i] = np.std(vv, ddof=ddof), True
            return Series(out, ok)
        return Expr(ev, self._name)

    # -- length-changing ---------------------------------------------------
    def filter(self, cond):
        cexp = _to_expr(cond)

        def ev(c):
            s = self._ev(c)
            cd = cexp._ev(c)
            s2, cd = _broadcast(s, cd)
            keep = cd.ok & cd.v.astype(bool)
            return Series(s2.v[keep], s2.ok[keep])
        return Expr(ev, self._name)

    def sort(self, descending=False):
        def ev(c):
            s = self._ev(c)
            vv = s.v[s.ok]
            order = np.argsort(_order_key(np.asarray(vv)), kind="stable")
            if descending:
                order = order[::-1]
            nulls = int((~s.ok).sum())
            if s.v.dtype.kind in "iuf":
                out = np.concatenate(
                    [np.full(nulls, np.nan), vv[order].astype(np.float64)]) \
                    if nulls else vv[order]
            else:
                out = np.concatenate([s.v[~s.ok], vv[order]])
            ok = np.concatenate([np.zeros(nulls, bool),
                                 np.ones(len(vv), bool)])
            return Series(out, ok)
        return Expr(ev, self._name)

    def top_k(self, k):
        def ev(c):
            return _topk(self._ev(c), k, largest=True)
        return Expr(ev, self._name)

    def bottom_k(self, k):
        def ev(c):
            return _topk(self._ev(c), k, largest=False)
        return Expr(ev, self._name)

    def unique(self):
        def ev(c):
            s = self._ev(c)
            return Series(np.unique(s.v[s.ok]))
        return Expr(ev, self._name)

    # -- aggregations ------------------------------------------------------
    def sum(self):
        return Expr(lambda c: _agg_sum(self._ev(c)), self._name)

    def product(self):
        return Expr(lambda c: _agg_product(self._ev(c)), self._name)

    def mean(self):
        return Expr(lambda c: _agg_mean(self._ev(c)), self._name)

    def std(self, ddof=1):
        return Expr(lambda c: _agg_std(self._ev(c), ddof), self._name)

    def var(self, ddof=1):
        return Expr(lambda c: _agg_var(self._ev(c), ddof), self._name)

    def skew(self):
        return Expr(lambda c: _agg_skew(self._ev(c)), self._name)

    def kurtosis(self):
        return Expr(lambda c: _agg_kurtosis(self._ev(c)), self._name)

    def first(self):
        return Expr(lambda c: _agg_first(self._ev(c)), self._name)

    def last(self):
        return Expr(lambda c: _agg_last(self._ev(c)), self._name)

    def min(self):
        return Expr(lambda c: _agg_min(self._ev(c)), self._name)

    def max(self):
        return Expr(lambda c: _agg_max(self._ev(c)), self._name)

    def len(self):
        return Expr(lambda c: Series.scalar(c.height), self._name)

    def count(self):
        def ev(c):
            s = self._ev(c)
            return Series.scalar(int(s.ok.sum()))
        return Expr(ev, self._name)

    @property
    def str(self):
        return _StrNS(self)

    def qcut(self, quantiles, labels=None, allow_duplicates=False):
        """Quantile bucketing (Factor.py:286-290).

        Breakpoints are linear-interpolation quantiles at i/k over the
        FINITE values; bins are right-closed ``(-inf, q1], (q1, q2],
        ...``; with ``allow_duplicates`` duplicate breakpoints collapse
        and the first ``n_bins`` labels are used (PIN — polars' exact
        label behavior under collapsed bins is not documented; the
        repo's eval_ops.qcut_labels pins the same reading). Null in ->
        null out, and NaN ALSO buckets to null — the pinned side of the
        Q12 ambiguity (see ``SEMANTIC_PINS['qcut_nan']``; the
        unverified alternative is NaN -> top bin under total order).
        """
        if not isinstance(quantiles, int):
            raise NotImplementedError("only integer qcut supported")
        k = quantiles

        def ev(c):
            s = self._ev(c)
            v = s.fl()
            val = v[s.ok]
            out = np.empty(len(s), dtype=object)
            ok = s.ok.copy()
            if val.size == 0:
                return Series(out, np.zeros(len(s), bool))
            finite = val[~np.isnan(val)]
            if finite.size == 0:
                breaks = np.empty(0)
            else:
                breaks = np.quantile(finite, np.arange(1, k) / k,
                                     method="linear")
            if allow_duplicates:
                breaks = np.unique(breaks)
            elif np.unique(breaks).size != breaks.size:
                raise ValueError("duplicate qcut breakpoints "
                                 "(allow_duplicates=False)")
            lab = labels if labels is not None else [
                f"bin_{i}" for i in range(breaks.size + 1)]
            if len(lab) < breaks.size + 1:
                raise ValueError("not enough qcut labels")
            # right-closed bins: index = first break >= value
            idx = np.searchsorted(breaks, v, side="left")
            if _pin_reading("qcut_nan") == "top_bin":
                # alternative reading: NaN sorts above +inf (polars
                # total order) -> last bucket; stays non-null
                idx = np.where(np.isnan(v), breaks.size, idx)
            else:
                # PIN (SEMANTIC_PINS['qcut_nan']): NaN buckets to null
                ok &= ~np.isnan(v)
            for i in np.nonzero(ok)[0]:
                out[i] = lab[idx[i]]
            return Series(out, ok)
        return Expr(ev, self._name)

    # -- window ------------------------------------------------------------
    def over(self, keys, *more):
        key_list = [keys] if isinstance(keys, str) else list(keys)
        key_list += list(more)

        def ev(c):
            out_v = None
            out_ok = np.zeros(c.height, bool)
            for idx in _partition_indices(c, key_list):
                sub = self._ev(c.take(idx))
                if out_v is None:
                    proto = sub.v if sub.v.dtype.kind not in "iu" \
                        else sub.v.astype(np.float64)
                    out_v = np.empty(c.height, dtype=np.float64
                                     if proto.dtype.kind in "iuf"
                                     else object)
                    if out_v.dtype.kind == "f":
                        out_v[:] = np.nan
                if len(sub) == 1 and idx.size != 1:
                    out_v[idx] = sub.v[0]
                    out_ok[idx] = sub.ok[0]
                elif len(sub) == idx.size:
                    out_v[idx] = sub.v
                    out_ok[idx] = sub.ok
                else:
                    raise ValueError(
                        f"over(): window produced length {len(sub)} for "
                        f"partition of {idx.size}")
            if out_v is None:
                out_v = np.empty(0)
            return Series(out_v, out_ok)
        return Expr(ev, self._name)


class _StrNS:
    """``Expr.str`` namespace — the slice/parse ops the reference's
    day-filename indexing uses (MinuteFrequentFactorCICC.py:74-77)."""

    def __init__(self, expr):
        self._e = expr

    def head(self, n):
        e = self._e

        def ev(c):
            s = e._ev(c)
            vals = np.asarray([x[:n] if isinstance(x, str) else x
                               for x in s.v], dtype=object)
            return Series(vals, s.ok.copy())
        return Expr(ev, e._name)

    def to_date(self, format="%Y-%m-%d"):
        import datetime as _dt
        e = self._e

        def ev(c):
            s = e._ev(c)
            out = np.zeros(len(s.v), dtype="datetime64[D]")
            ok = s.ok.copy()
            for i, x in enumerate(s.v):
                if ok[i]:
                    # a bad input raises ValueError (real polars raises
                    # its ComputeError; both abort the query loudly)
                    out[i] = np.datetime64(
                        _dt.datetime.strptime(str(x), format).date())
            return Series(out, ok)
        return Expr(ev, e._name)


class _Col(Expr):
    __slots__ = ()

    def __init__(self, name):
        def ev(c, _n=name):
            try:
                return c.cols[_n]
            except KeyError:
                raise KeyError(
                    f"column {_n!r} not in scope "
                    f"{sorted(c.cols)}") from None
        super().__init__(ev, name)


def col(name):
    if isinstance(name, (list, tuple)):
        raise NotImplementedError("pl.col(list) not used by the reference")
    return _Col(name)


def lit(value):
    if value is None:
        return Expr(lambda c: Series(np.full(1, np.nan),
                                     np.zeros(1, bool)), "literal")
    return Expr(lambda c, _v=value: Series.scalar(_v), "literal")


# pl.len() — exposed as the ``len`` attribute of the proxy module the
# harness installs (defining a module-level ``len`` here would shadow the
# builtin for every internal call in this file).
def _pl_len():
    return Expr(lambda c: Series.scalar(c.height), "len")


def corr(a, b, method="pearson", **kw):
    ea, eb = _to_col(a), _to_col(b)
    if method == "pearson":
        return Expr(lambda c: _corr2(ea._ev(c), eb._ev(c)), "corr")
    if method == "spearman":
        # rank (average ties) the pairwise-complete pairs, then Pearson
        def ev(c):
            sa, sb = ea._ev(c), eb._ev(c)
            sa, sb = _broadcast(sa, sb)
            both = sa.ok & sb.ok
            av, bv = sa.fl()[both], sb.fl()[both]
            keep = ~(np.isnan(av) | np.isnan(bv))
            ra = _rank_avg(Series(av[keep]))
            rb = _rank_avg(Series(bv[keep]))
            return _corr2(ra, rb)
        return Expr(ev, "corr")
    raise NotImplementedError(method)


def cov(a, b=None, ddof=1, **kw):
    ea, eb = _to_col(a), _to_col(b)
    return Expr(lambda c: _cov2(ea._ev(c), eb._ev(c), ddof), "cov")


def var(column, ddof=1):
    e = _to_col(column)
    return Expr(lambda c: _agg_var(e._ev(c), ddof), "var")


def _to_col(x):
    return col(x) if isinstance(x, str) else _to_expr(x)


# --------------------------------------------------------------------------
# when / then / otherwise
# --------------------------------------------------------------------------

class _When:
    def __init__(self, branches, cond):
        self._branches = branches  # [(cond_expr, value_expr), ...]
        self._cond = _to_expr(cond)

    def then(self, value):
        return _Then(self._branches + [(self._cond, _to_expr(value))])


class _Then:
    def __init__(self, branches):
        self._branches = branches

    def when(self, cond):
        return _When(self._branches, cond)

    def otherwise(self, value):
        branches = self._branches
        other = _to_expr(value)

        def ev(c):
            # natural length = the non-scalar part length (0 counts: an
            # empty frame stays empty); when every condition and branch
            # is a scalar aggregate (agg context), the result stays
            # scalar — broadcasting to frame height is the caller's job
            # (_expand in select/with_columns)
            evs = []
            lengths = set()
            for cond, val in branches:
                cs, vs = cond._ev(c), val._ev(c)
                evs.append((cs, vs))
                lengths.update((_shim_len(cs), _shim_len(vs)))
            os_ = other._ev(c)
            lengths.add(_shim_len(os_))
            non_scalar = lengths - {1}
            if len(non_scalar) > 1:
                raise ValueError(f"when/then length mix {sorted(lengths)}")
            height = non_scalar.pop() if non_scalar else 1
            taken = np.zeros(height, bool)
            out_v = np.full(height, np.nan)
            out_ok = np.zeros(height, bool)
            for cs, vs in evs:
                cs = _expand(cs, height)
                vs = _expand(vs, height)
                if vs.v.dtype.kind not in "iufb":
                    raise NotImplementedError(
                        "when/then branches must be numeric; got dtype "
                        f"{vs.v.dtype} (the reference only branches on "
                        "numerics)")
                hit = (~taken) & cs.ok & cs.v.astype(bool)
                out_v[hit] = vs.v[hit].astype(np.float64)
                out_ok[hit] = vs.ok[hit]
                taken |= hit
            os_ = _expand(os_, height)
            if os_.v.dtype.kind not in "iufb":
                raise NotImplementedError(
                    f"otherwise branch must be numeric; got {os_.v.dtype}")
            rest = ~taken
            out_v[rest] = os_.v[rest].astype(np.float64)
            out_ok[rest] = os_.ok[rest]
            return Series(out_v, out_ok)
        # polars names the result after the first then-branch
        name = branches[0][1]._name if branches else "literal"
        return Expr(ev, name)


def _shim_len(s: Series) -> int:
    return s.v.shape[0]


def _expand(s: Series, height: int) -> Series:
    if _shim_len(s) == height:
        return s
    if _shim_len(s) == 1:
        return Series(np.repeat(s.v, height), np.repeat(s.ok, height))
    raise ValueError(f"length {_shim_len(s)} vs height {height}")


def when(cond):
    return _When([], cond)


# --------------------------------------------------------------------------
# DataFrame / LazyFrame / GroupBy / Rolling
# --------------------------------------------------------------------------

def _partition_indices(c: Ctx, keys):
    """Row-index arrays per group, groups in ascending key order (PIN:
    ``SEMANTIC_PINS['group_order']``)."""
    if c.height == 0:
        return []
    cols = [c.cols[k] for k in keys]
    rows = {}
    arrs = [s.v for s in cols]
    for i in range(c.height):
        key = tuple(a[i].item() if hasattr(a[i], "item") else a[i]
                    for a in arrs)
        rows.setdefault(key, []).append(i)
    out = []
    for key in sorted(rows):
        out.append(np.asarray(rows[key], dtype=np.int64))
    return out


class DataFrame:
    def __init__(self, data=None, schema=None):
        # ``schema`` (MinuteFrequentFactorCICC.py:72) is accepted and
        # only sanity-checked: the shim infers dtypes from the values
        if data is None:
            data = {}
        if schema is not None and isinstance(data, dict):
            unknown = set(schema) - set(data)
            if unknown:
                raise ValueError(f"schema names {unknown} not in data")
        if isinstance(data, dict):
            cols = {}
            height = None
            for k, v in data.items():
                s = v if isinstance(v, Series) else Series(np.asarray(v))
                cols[k] = s
                if height is not None and _shim_len(s) != height:
                    raise ValueError(  # real polars raises ShapeError
                        f"column {k!r} length {_shim_len(s)} != {height}")
                height = _shim_len(s)
            self._cols = cols
            self._height = height or 0
        else:
            raise NotImplementedError(type(data))

    # internal
    @staticmethod
    def _from_ctx(ctx: Ctx) -> "DataFrame":
        df = DataFrame()
        df._cols = ctx.cols
        df._height = ctx.height
        return df

    @staticmethod
    def _raw(cols: dict) -> "DataFrame":
        df = DataFrame()
        df._cols = cols
        df._height = _shim_len(next(iter(cols.values()))) if cols else 0
        return df

    def _ctx(self) -> Ctx:
        return Ctx(dict(self._cols), self._height)

    # introspection
    @property
    def height(self):
        return self._height

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        return self._height

    def __getitem__(self, name):
        return self._cols[name]

    def to_dict_of_numpy(self):
        """values with NaN at nulls (harness convenience, not polars API)."""
        out = {}
        for k, s in self._cols.items():
            out[k] = s.fl() if s.v.dtype.kind in "iuf" else s.v
        return out

    # lazy API is a no-op: every op here is eager and pure
    def lazy(self):
        return self

    def collect(self):
        return self

    # core verbs
    def filter(self, *conds):
        keep = np.ones(self._height, bool)
        c = self._ctx()
        for cond in conds:
            s = _to_expr(cond)._ev(c)
            s = _expand(s, self._height)
            keep &= s.ok & s.v.astype(bool)
        return DataFrame._from_ctx(c.take(keep))

    def _eval_into(self, exprs, base):
        c = self._ctx()
        out = dict(base)
        for e in exprs:
            if isinstance(e, str):
                out[e] = self._cols[e]
                continue
            s = e._ev(c)
            s = _expand(s, self._height) if self._height else s
            out[e._name] = s
        return out

    def with_columns(self, *exprs):
        exprs = _flatten(exprs)
        cols = self._eval_into(exprs, self._cols)
        df = DataFrame()
        df._cols = cols
        df._height = self._height
        return df

    def select(self, *exprs):
        exprs = _flatten(exprs)
        cols = self._eval_into(exprs, {})
        df = DataFrame()
        df._cols = cols
        heights = {_shim_len(s) for s in cols.values()}
        df._height = max(heights) if heights else 0
        return df

    def sort(self, by=None, *more, descending=False):
        keys = [by] if isinstance(by, str) else list(by)
        keys += list(more)
        cols = [self._cols[k] for k in keys]
        if all(s.ok.all() and s.v.dtype.kind != "O" for s in cols):
            order = np.lexsort([s.v for s in reversed(cols)])
        else:
            # null-aware path (nulls first, polars default); object
            # columns can hold None cells that break lexsort
            def row_key(i):
                out = []
                for s in cols:
                    if s.ok[i]:
                        out.append((1, s.v[i]))
                    else:
                        out.append((0, 0))
                return tuple(out)
            order = sorted(range(self._height), key=row_key)
            order = np.asarray(order, dtype=np.int64)
        if descending:
            order = order[::-1]
        return DataFrame._from_ctx(self._ctx().take(order))

    def rename(self, mapping):
        df = DataFrame()
        df._cols = {mapping.get(k, k): v for k, v in self._cols.items()}
        df._height = self._height
        return df

    def drop(self, *names):
        names = set(_flatten(names))
        df = DataFrame()
        df._cols = {k: v for k, v in self._cols.items() if k not in names}
        df._height = self._height
        return df

    def group_by(self, keys, *more, maintain_order=False):
        key_list = [keys] if isinstance(keys, str) else list(keys)
        key_list += [m for m in more if isinstance(m, str)]
        return GroupBy(self, key_list)

    def rolling(self, index_column, period, group_by=None, **kw):
        return Rolling(self, index_column, period, group_by or [])

    def group_by_dynamic(self, index_column=None, *, every, label="left",
                         group_by=None, closed="left", **kw):
        if index_column is None:
            # PIN (quirk Q13): cal_final_exposure calls group_by_dynamic
            # with NO index_column (MinuteFrequentFactorCICC.py:145,155,
            # 165,178) — modern polars rejects that call outright
            # (index_column is required), so the reference's calendar
            # mode cannot have run as written on a current engine. The
            # shim infers the frame's unique datetime column, the only
            # reading under which the method works at all; the repo's
            # resampler implements the same reading.
            dt_cols = [k for k, s in self._cols.items()
                       if s.v.dtype.kind == "M"]
            if len(dt_cols) != 1:
                raise ValueError(
                    f"cannot infer dynamic index column from {dt_cols}")
            index_column = dt_cols[0]
        keys = [] if group_by is None else (
            [group_by] if isinstance(group_by, str) else list(group_by))
        return DynamicGroupBy(self, index_column, every, label, keys)

    def join(self, other, on, how="inner"):
        on_list = [on] if isinstance(on, str) else list(on)
        return _join(self, other, on_list, how)

    def write_parquet(self, path, **kw):
        import pyarrow as pa
        import pyarrow.parquet as pq

        arrays = {}
        for k, s in self._cols.items():
            if s.v.dtype.kind == "M":
                arrays[k] = pa.array(s.v.astype("datetime64[D]"),
                                     mask=~s.ok)
            elif s.v.dtype.kind in "iufb":
                arrays[k] = pa.array(s.v, mask=~s.ok)
            else:
                arrays[k] = pa.array(
                    [str(x) if o else None for x, o in zip(s.v, s.ok)],
                    type=pa.string())
        pq.write_table(pa.table(arrays), path)


LazyFrame = DataFrame


class GroupBy:
    def __init__(self, df: DataFrame, keys):
        self._df = df
        self._keys = keys

    def agg(self, *exprs):
        exprs = _flatten(exprs)
        c = self._df._ctx()
        parts = _partition_indices(c, self._keys)
        key_out = {k: [] for k in self._keys}
        names = [e._name for e in exprs]
        if len(set(names)) != len(names):
            raise ValueError(  # real polars raises DuplicateError
                f"duplicate agg output names {names}; use .alias()")
        # pre-create expr columns so zero groups still yield the schema
        agg_out = {e._name: [] for e in exprs}
        agg_ok = {e._name: [] for e in exprs}
        for idx in parts:
            sub = c.take(idx)
            for k in self._keys:
                key_out[k].append(sub.cols[k].v[0])
            for e in exprs:
                s = e._ev(sub)
                if _shim_len(s) != 1:
                    raise ValueError(
                        f"agg expression {e._name!r} returned length "
                        f"{_shim_len(s)} (list aggs unsupported)")
                agg_out.setdefault(e._name, []).append(s.v[0])
                agg_ok.setdefault(e._name, []).append(bool(s.ok[0]))
        df = DataFrame()
        cols = {}
        for k in self._keys:
            cols[k] = Series(np.asarray(key_out[k]))
        for name, vals in agg_out.items():
            oka = np.asarray(agg_ok[name], bool)
            cols[name] = Series(_column_from_cells(vals, oka), oka)
        df._cols = cols
        df._height = len(parts)
        return df


class Rolling:
    """LazyFrame.rolling(index_column, period='Ni', group_by=[...]).

    One output row per input row: aggregates over the same-group rows
    whose index value lies in ``(t - N, t]`` (polars' default closed=
    'right' window with offset=-period). The index must be sorted
    non-decreasing within each group, as real polars requires.
    """

    def __init__(self, df, index_column, period, group_by):
        if not (isinstance(period, str) and period.endswith("i")):
            raise NotImplementedError(f"period {period!r}")
        self._df = df
        self._idx = index_column
        self._n = int(period[:-1])
        self._keys = [group_by] if isinstance(group_by, str) \
            else list(group_by)

    def agg(self, *exprs):
        exprs = _flatten(exprs)
        c = self._df._ctx()
        parts = _partition_indices(c, self._keys) if self._keys \
            else [np.arange(c.height)]
        key_cols = {k: [] for k in self._keys}
        idx_vals = []
        agg_out = {e._name: [] for e in exprs}
        agg_ok = {e._name: [] for e in exprs}
        for idx in parts:
            sub = c.take(idx)
            ts = sub.cols[self._idx]
            if not ts.ok.all():
                raise ValueError("null in rolling index column")
            tv = ts.v.astype(np.int64)
            if len(tv) and (np.diff(tv) < 0).any():
                raise ValueError("rolling index not sorted within group")
            for i in range(sub.height):
                t = tv[i]
                lo = np.searchsorted(tv, t - self._n, side="right")
                hi = np.searchsorted(tv, t, side="right")
                win = sub.take(np.arange(lo, hi))
                for k in self._keys:
                    key_cols[k].append(sub.cols[k].v[0])
                idx_vals.append(t)
                for e in exprs:
                    s = e._ev(win)
                    if _shim_len(s) != 1:
                        raise ValueError("rolling agg must be scalar")
                    agg_out.setdefault(e._name, []).append(s.v[0])
                    agg_ok.setdefault(e._name, []).append(bool(s.ok[0]))
        df = DataFrame()
        cols = {}
        for k in self._keys:
            cols[k] = Series(np.asarray(key_cols[k]))
        cols[self._idx] = Series(np.asarray(idx_vals))
        for name, vals in agg_out.items():
            va = np.asarray(vals, dtype=np.float64)
            oka = np.asarray(agg_ok[name], bool)
            va[~oka] = np.nan
            cols[name] = Series(va, oka)
        df._cols = cols
        df._height = len(idx_vals)
        return df


def _bucket_start(d: np.ndarray, every: str) -> np.ndarray:
    """Calendar window start per date (polars dynamic-window truncation:
    weeks start Monday, months/quarters/years at their first day)."""
    d = d.astype("datetime64[D]")
    if every == "1d":
        return d
    if every == "1w":
        di = d.astype(np.int64)  # days since 1970-01-01 (a Thursday)
        return (di - (di + 3) % 7).astype("datetime64[D]")
    if every == "1mo":
        return d.astype("datetime64[M]").astype("datetime64[D]")
    if every == "1q":
        m = d.astype("datetime64[M]").astype(np.int64)
        return ((m // 3) * 3).astype("datetime64[M]").astype("datetime64[D]")
    if every == "1y":
        return d.astype("datetime64[Y]").astype("datetime64[D]")
    raise NotImplementedError(f"every={every!r}")


def _bucket_label(start: np.datetime64, every: str, label: str):
    if label == "left":
        return start
    if label != "right":
        raise NotImplementedError(f"label={label!r}")
    if every == "1d":
        return start + np.timedelta64(1, "D")
    if every == "1w":
        return start + np.timedelta64(7, "D")
    if every == "1mo":
        return ((start.astype("datetime64[M]") + 1)
                .astype("datetime64[D]"))
    if every == "1q":
        return ((start.astype("datetime64[M]") + 3)
                .astype("datetime64[D]"))
    if every == "1y":
        return ((start.astype("datetime64[Y]") + 1)
                .astype("datetime64[D]"))
    raise NotImplementedError(f"every={every!r}")


class DynamicGroupBy:
    """group_by_dynamic(index, every=..., label=..., group_by=...)
    (Factor.py:293-304, MinuteFrequentFactorCICC.py:145-178): calendar
    windows per group; one output row per non-empty window, windows in
    ascending start order, rows within a window in input order."""

    def __init__(self, df, index_column, every, label, keys):
        self._df = df
        self._idx = index_column
        self._every = every
        self._label = label
        self._keys = keys

    def agg(self, *exprs):
        exprs = _flatten(exprs)
        c = self._df._ctx()
        parts = _partition_indices(c, self._keys) if self._keys \
            else [np.arange(c.height)]
        key_cols = {k: [] for k in self._keys}
        idx_vals = []
        agg_out = {e._name: [] for e in exprs}
        agg_ok = {e._name: [] for e in exprs}
        for idx in parts:
            sub = c.take(idx)
            d = sub.cols[self._idx]
            if not d.ok.all():
                raise ValueError("null in dynamic index column")
            starts = _bucket_start(d.v, self._every)
            for b in np.unique(starts):
                sel = np.nonzero(starts == b)[0]
                win = sub.take(sel)
                for k in self._keys:
                    key_cols[k].append(sub.cols[k].v[0])
                idx_vals.append(_bucket_label(b, self._every, self._label))
                for e in exprs:
                    s = e._ev(win)
                    if _shim_len(s) != 1:
                        raise ValueError("dynamic agg must be scalar")
                    agg_out[e._name].append(s.v[0])
                    agg_ok[e._name].append(bool(s.ok[0]))
        df = DataFrame()
        cols = {}
        for k in self._keys:
            cols[k] = Series(np.asarray(key_cols[k]))
        cols[self._idx] = Series(np.asarray(idx_vals,
                                            dtype="datetime64[D]"))
        for name, vals in agg_out.items():
            oka = np.asarray(agg_ok[name], bool)
            va = _column_from_cells(vals, oka)
            cols[name] = Series(va, oka)
        df._cols = cols
        df._height = len(idx_vals)
        return df


def _column_from_cells(vals, oka):
    """Assemble an agg output column from per-group scalar cells,
    keeping numeric dtype when possible and NaN-ing invalid slots."""
    va = np.asarray(vals)
    if va.dtype.kind in "iu" and not oka.all():
        va = va.astype(np.float64)
    if va.dtype.kind == "f":
        va = va.copy()
        va[~oka] = np.nan
    return va


def _flatten(exprs):
    out = []
    for e in exprs:
        if isinstance(e, (list, tuple)):
            out.extend(e)
        else:
            out.append(e)
    return out


def _join(left: DataFrame, right: DataFrame, on, how):
    lc, rc = left._ctx(), right._ctx()
    rkeys = {}
    for i in range(rc.height):
        key = tuple(rc.cols[k].v[i].item() if hasattr(rc.cols[k].v[i],
                    "item") else rc.cols[k].v[i] for k in on)
        rkeys.setdefault(key, []).append(i)
    li, ri = [], []
    for i in range(lc.height):
        key = tuple(lc.cols[k].v[i].item() if hasattr(lc.cols[k].v[i],
                    "item") else lc.cols[k].v[i] for k in on)
        matches = rkeys.get(key, [])
        if matches:
            for j in matches:
                li.append(i)
                ri.append(j)
        elif how == "left":
            li.append(i)
            ri.append(-1)
    li = np.asarray(li, dtype=np.int64)
    ri = np.asarray(ri, dtype=np.int64)
    cols = {}
    for k, s in lc.cols.items():
        cols[k] = Series(s.v[li], s.ok[li])
    miss = ri < 0
    rj = np.where(miss, 0, ri)
    for k, s in rc.cols.items():
        if k in on:
            continue
        name = k if k not in cols else k + "_right"
        v = s.v[rj]
        ok = s.ok[rj] & ~miss
        if v.dtype.kind in "iu" and miss.any():
            v = v.astype(np.float64)
        if v.dtype.kind == "f":
            v = v.copy()
            v[miss] = np.nan
        cols[name] = Series(v, ok)
    df = DataFrame()
    df._cols = cols
    df._height = len(li)
    return df


def concat(items, how="vertical"):
    frames = list(items)
    if how == "vertical":
        cols = {}
        names = frames[0].columns
        for k in names:
            vs = [f._cols[k].v for f in frames]
            oks = [f._cols[k].ok for f in frames]
            vals = np.concatenate([np.asarray(v) for v in vs])
            cols[k] = Series(vals, np.concatenate(oks))
        df = DataFrame()
        df._cols = cols
        df._height = sum(f.height for f in frames)
        return df
    if how == "align_left":
        # PIN (quirk Q10, Factor.py:163-171,280-283): align on the
        # columns common to every frame, keep only the left-most frame's
        # key rows (left join), output sorted ascending by the common
        # columns in the left frame's column order — matching polars'
        # documented align behavior.
        common = [c for c in frames[0].columns
                  if all(c in f.columns for f in frames[1:])]
        out = frames[0]
        for f in frames[1:]:
            out = _join(out, f, common, "left")
        return out.sort(by=common)
    raise NotImplementedError(f"concat how={how!r}")


def read_parquet(path, **kw):
    """Parquet -> shim DataFrame via pyarrow, preserving null masks
    (polars nulls round-trip; NaN stays a value)."""
    import pyarrow.parquet as pq

    t = pq.read_table(path)
    cols = {}
    for name in t.column_names:
        col = t.column(name)
        arr = col.to_numpy(zero_copy_only=False)
        ok = ~np.asarray(col.is_null().to_numpy(zero_copy_only=False))
        if arr.dtype.kind == "M":
            arr = arr.astype("datetime64[D]")
        elif arr.dtype.kind == "O":
            first = next((x for x in arr if x is not None), None)
            import datetime as _dt
            if isinstance(first, _dt.date):
                vals = np.zeros(len(arr), dtype="datetime64[D]")
                for i, x in enumerate(arr):
                    if ok[i]:
                        vals[i] = np.datetime64(x)
                arr = vals
            else:
                arr = np.asarray([x if x is not None else "" for x in arr],
                                 dtype=object)
        cols[name] = Series(arr, ok)
    return DataFrame._raw(cols)


def scan_parquet(path, **kw):
    return read_parquet(path, **kw)


# dtypes (identity objects; only compared by ``is`` / equality)
class _DType:
    def __init__(self, name):
        self._n = name

    def __repr__(self):
        return self._n


Int8 = _DType("Int8")
Int16 = _DType("Int16")
Int32 = _DType("Int32")
Int64 = _DType("Int64")
UInt32 = _DType("UInt32")
UInt64 = _DType("UInt64")
Float32 = _DType("Float32")
Float64 = _DType("Float64")
Boolean = _DType("Boolean")
String = _DType("String")
Utf8 = String
Date = _DType("Date")

_INT_DTYPES = {Int8, Int16, Int32, Int64, UInt32, UInt64}
_FLOAT_DTYPES = {Float32, Float64}
_STR_DTYPES = {String}
