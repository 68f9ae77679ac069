"""Crafted inputs shared by the port's tests and ``chip_smoke.py``.

numpy and torch only (no jax): ``chip_smoke.py`` loads this file by path
on the card, and the CPU tests import it as a sibling module. Nothing
here is collected as a test.
"""

import numpy as np
import torch

#: (dclose, ohl, volume) rungs of the wire's ladders that batches are
#: crafted for: every rung of every ladder
WIRE_MODE_CASES = ((0, 0, 0), (1, 1, 1), (2, 2, 2), (1, 3, 3), (0, 1, 4))


def wire_mode_case(seed: int, n_slots: int, dclose_mode: int, ohl_mode: int,
                   vol_mode: int, lead=(2, 6)):
    """Tick-aligned bars ``[*lead, S, 5]`` (zero on absent bars) and mask
    whose wire encoding lands on the given rung of each ladder
    (``native.DCLOSE_SHAPES``, ``OHL_SHAPES``, ``VOL_SHAPES``). One lane of
    the first row holds each field's extreme, so no narrower rung fits; a
    rung the slot count cannot pack (vol10 needs S % 4 == 0) lands on the
    next that it can, as :func:`expected_wire_modes` says."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (n_slots,)
    mask = rng.random(shape) > 0.1
    first = (0,) * len(lead)
    mask[first][:8] = True
    step = (7, 127, 2000)[dclose_mode]
    steps = rng.integers(-step, step + 1, shape)
    steps[first + (5,)] = step
    ct = (rng.integers(500_000, 1_000_000, tuple(lead))[..., None]
          + np.cumsum(np.where(mask, steps, 0), axis=-1))
    lo, hi, wick = ((-8, 7, 3), (-127, 127, 15), (-50, 50, 40),
                    (-50, 50, 40))[ohl_mode]
    dop = rng.integers(lo, hi + 1, shape)
    up = rng.integers(0, wick + 1, shape)
    down = rng.integers(0, wick + 1, shape)
    if ohl_mode == 1:
        dop[first + (6,)] = 100  # past the tight packing's int4
    elif ohl_mode == 2:
        up[first + (6,)] = 40    # past the wick packing's nibble
    elif ohl_mode == 3:
        up[first + (6,)] = 500   # past int8
    ot = ct + dop
    ht = np.maximum(ct, ot) + up
    lt = np.minimum(ct, ot) - down
    top, lots = ((1023, 1), (1023, 100), (65535, 1), (65535, 100),
                 (10_000_000, 1))[vol_mode]
    vol = rng.integers(0, top + 1, shape) * lots
    vol[first + (7,)] = top * lots
    if lots == 1 and vol_mode:
        vol[first + (6,)] = 7    # not a board lot
    bars = np.stack([t / 100.0 for t in (ot, ht, lt, ct)] + [vol], axis=-1)
    bars = np.where(mask[..., None], bars, 0.0).astype(np.float32)
    return bars, mask


def expected_wire_modes(n_slots: int, dclose_mode: int, ohl_mode: int,
                        vol_mode: int) -> dict:
    """The modes :func:`wire_mode_case`'s batch encodes at."""
    if n_slots % 2:
        dclose_mode = max(dclose_mode, 1)
    if n_slots % 4 and vol_mode < 2:
        vol_mode += 2
    return {"dclose_mode": dclose_mode, "ohl_mode": ohl_mode,
            "vol_mode": vol_mode}


def crafted_rows(seed: int = 64, rows: int = 8, lanes: int = 64):
    """``[rows, lanes]`` rows of heavy ties (quarter steps) with garbage in
    the invalid lanes, the first seven crafted as a sort must place them
    exactly: -0.0 next to +0.0, a valid ``+inf`` and ``-inf``, +NaN and
    -NaN valid lanes, an all-invalid row, a NaN in an invalid lane, one
    tie group of signed zeros, one value with invalid lanes, all valid."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (rows, lanes)) / 4).astype(np.float32)
    mask = rng.random((rows, lanes)) < 0.8
    x[~mask] = rng.normal(0, 1e3, int((~mask).sum()))
    x[0, :6] = [-0.0, 0.0, np.inf, np.nan, -np.nan, -np.inf]
    mask[0, :6] = True
    x[1, :8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, np.nan, 0.0]
    mask[1] = True
    mask[2] = False
    x[3, 3], mask[3, 3] = np.nan, False
    x[4] = np.where(np.arange(lanes) % 2, -0.0, 0.0)
    x[5] = 1.5
    mask[6] = True
    return x, mask


def same_bits(a, b) -> bool:
    """Bitwise equality of two float32 (or integer/bool) tensors."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b.to(a.device))


#: group counts the quantile labels are held at: 3, 6, 7 and 10 are among
#: those where torch.linspace's levels differ from jnp.linspace's
QCUT_GROUPS = (2, 3, 5, 6, 7, 10, 20)


def weekdays(n: int, start: str = "2024-01-02") -> np.ndarray:
    """``n`` weekdays from ``start`` (a stand-in trading calendar)."""
    days = np.arange(np.datetime64(start, "D"),
                     np.datetime64(start, "D") + 2 * n + 7)
    return days[(days.astype(np.int64) + 3) % 7 < 5][:n]


def eval_exposure(seed: int, codes, dates, absent: float = 0.02,
                  nan: float = 0.01, tie_step: float = 0.05):
    """A seeded long-format exposure ``{code, date, value}`` over ``codes``
    x ``dates`` (date-major, as a cache is sorted): normal values rounded
    to ``tie_step`` on every other code (heavy ties), an ``absent`` share of
    rows dropped and a ``nan`` share of the rest NaN."""
    rng = np.random.default_rng(seed)
    dd, cc = np.meshgrid(np.asarray(dates, "datetime64[D]"),
                         np.asarray(codes), indexing="ij")
    v = rng.normal(0, 1, dd.shape)
    v[:, ::2] = np.round(v[:, ::2] / tie_step) * tie_step
    v[rng.random(dd.shape) < nan] = np.nan
    keep = rng.random(dd.shape) >= absent
    return {"code": cc[keep].astype(object), "date": dd[keep],
            "value": v[keep].astype(np.float32)}


def eval_pv(seed: int, codes, dates, absent: float = 0.03):
    """A seeded daily PV table ``{code, date, pct_change, tmc, cmc}`` over
    ``codes`` x ``dates``, code-major, an ``absent`` share of rows dropped
    (suspended days); caps are constant per code, cmc 0.7 of tmc."""
    rng = np.random.default_rng(seed)
    cc, dd = np.meshgrid(np.asarray(codes), np.asarray(dates,
                                                       "datetime64[D]"),
                         indexing="ij")
    keep = rng.random(cc.shape) >= absent
    pct = rng.normal(0, 0.02, cc.shape)
    mc = np.broadcast_to(rng.uniform(1e9, 5e10, (cc.shape[0], 1)), cc.shape)
    return {"code": cc[keep].astype(str), "date": dd[keep],
            "pct_change": pct[keep], "tmc": mc[keep], "cmc": 0.7 * mc[keep]}


def write_pv(pv: dict, path) -> None:
    """``eval_pv``'s table as the parquet ``Factor`` reads."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({
        "code": pa.array([str(c) for c in pv["code"]]),
        "date": pa.array(np.asarray(pv["date"], "datetime64[D]")),
        **{k: pa.array(np.asarray(pv[k], np.float64))
           for k in ("pct_change", "tmc", "cmc")}}), str(path))


def eval_matrices(seed: int, n_dates: int, n_codes: int,
                  absent: float = 0.02):
    """Dense ``[dates, codes]`` evaluation inputs: an f32 exposure with
    ties (half the lanes on a 0.05 grid), an f32 forward return loosely
    tied to it, and ``valid`` with an ``absent`` share of lanes cleared
    (their values garbage, as a pivot's NaN through ``nan_to_num``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n_dates, n_codes))
    x[:, ::2] = np.round(x[:, ::2] / 0.05) * 0.05
    fwd = 0.01 * x + rng.normal(0, 0.02, x.shape)
    valid = rng.random(x.shape) >= absent
    x = np.where(valid, x, 0.0).astype(np.float32)
    fwd = np.where(valid, fwd, 0.0).astype(np.float32)
    return x, fwd, valid


def qcut_cases():
    """``{name: (exposure [D, T] f32, valid [D, T], nan_lanes [D, T])}``:
    the cross-sections a quantile cut must place exactly. ``nan_lanes``
    marks value-NaN lanes (present, not valid; the exposure there is 0, as
    after ``nan_to_num``)."""
    rng = np.random.default_rng(90)
    out = {}
    x = rng.normal(size=(6, 97)).astype(np.float32)
    m = rng.random(x.shape) > 0.15
    out["random"] = (x, m)
    # tests/test_factor_eval.py's duplicate-break case: a 0.1 grid
    x = np.round(rng.normal(0, 1, (3, 40)), 1).astype(np.float32)
    out["duplicate_breaks"] = (x, rng.random(x.shape) > 0.2)
    x = (rng.integers(-3, 4, (4, 64)) * 0.1).astype(np.float32)
    out["few_values"] = (x, rng.random(x.shape) > 0.1)
    # fuzz seed 6290: a [v, v] cross-section of a value f32 cannot hold
    vals = np.array([-0.1, 0.3, 1e-7, -3.3333, 2.5], np.float32)
    x = np.repeat(vals[:, None], 8, axis=1)
    m = np.zeros(x.shape, bool)
    m[:, :2] = True
    out["fuzz_6290_pairs"] = (x, m)
    # one valid lane; every lane one value; every lane invalid; signed zeros
    x = np.stack([np.ones(8), np.full(8, 2.5), rng.normal(size=8),
                  np.where(np.arange(8) % 2, -0.0, 0.0)]).astype(np.float32)
    m = np.ones(x.shape, bool)
    m[0] = np.arange(8) == 3
    m[2] = False
    out["degenerate"] = (x, m)
    cases = {}
    for name, (x, m) in out.items():
        nan_lanes = ~m & (rng.random(x.shape) < 0.3)
        cases[name] = (x, m, nan_lanes)
    return cases


def stream_day(seed: int, tickers: int, n_slots: int = 240):
    """One day ``(bars [T, S, 5] f32, mask [T, S])`` drawn as the JAX
    package's ``bench.make_batch`` draws a batch day: a tick-aligned close
    random walk, open within 1e-4 of it, a 2-bps wick, board-lot volume
    (zero on some bars), 2% of bars missing. Absent bars keep their drawn
    values: the kernels must never read them."""
    rng = np.random.default_rng(seed)
    shape = (1, tickers, n_slots)
    close = 10.0 * np.exp(np.cumsum(
        rng.standard_normal(shape, dtype=np.float32) * np.float32(1e-3),
        axis=-1))
    open_ = close * (1 + rng.standard_normal(shape, dtype=np.float32)
                     * np.float32(1e-4))
    high = np.maximum(open_, close) * 1.0002
    low = np.minimum(open_, close) * 0.9998
    volume = (rng.integers(0, 1000, shape) * 100).astype(np.float32)
    bars = np.stack([open_, high, low, close, volume], axis=-1)
    bars[..., :4] = np.round(bars[..., :4], 2)
    mask = rng.random(shape, dtype=np.float32) > 0.02
    return bars[0].astype(np.float32), mask[0]


def minutes_of(bars, mask, lo: int, hi: int):
    """Minutes ``[lo, hi)`` of a day as an ingest micro-batch: ``(bars
    [B, T, 5], present [B, T])``."""
    return (np.ascontiguousarray(np.swapaxes(bars[:, lo:hi], 0, 1)),
            np.ascontiguousarray(mask[:, lo:hi].T))


def feed(engine, bars, mask, lo: int, hi: int, micro: int = 8) -> None:
    """Ingest minutes ``[lo, hi)`` into ``engine`` ``micro`` at a time."""
    s = lo
    while s < hi:
        e = min(s + micro, hi)
        engine.ingest_minutes(*minutes_of(bars, mask, s, e))
        s = e


def feed_cohorts(engine, bars, mask, lo: int, hi: int, k: int) -> None:
    """Ingest minutes ``[lo, hi)`` as ``k``-ticker cohorts (the absent
    tickers and the last cohort's short tail padded with ``idx == T``),
    advancing after each minute."""
    n = mask.shape[0]
    for t in range(lo, hi):
        for c0 in range(0, n, k):
            sel = np.arange(c0, min(c0 + k, n))
            idx = np.where(mask[sel, t], sel, n).astype(np.int32)
            rows = np.ascontiguousarray(bars[sel, t])
            if len(sel) < k:
                idx = np.concatenate([idx, np.full(k - len(sel), n,
                                                   np.int32)])
                rows = np.concatenate(
                    [rows, np.zeros((k - len(sel), 5), np.float32)])
            engine.ingest_cohort(rows, idx)
        engine.advance()


def prefix_day(bars, mask, t_stop: int):
    """The day cut at minute ``t_stop``: bars of absent and later lanes
    zeroed, later slots masked out (what a carry holds at that minute)."""
    keep = np.zeros_like(mask)
    keep[:, :t_stop] = mask[:, :t_stop]
    return np.where(keep[..., None], bars, 0.0).astype(np.float32), keep


#: the search ops whose conditioning is bounded, by slot kind (PUSH,
#: UNARY, BINARY, MASK, AGG): every feature but the day-constant
#: gap/prev_ret and the tod ramp; unary without the z-score and the
#: rolling stds; binary without the protected divide and the rolling
#: corr; every mask; aggregates without the std. A z-score, std or corr
#: of a series that is constant in exact arithmetic, or a division by
#: such a value, turns each evaluation's rounding into an answer of its
#: own (tests/test_torch_search.py), so populations compared across
#: frameworks or devices draw from these
SEARCH_BOUNDED_OPS = {0: (0, 1, 2, 3, 4, 5, 6, 7, 11),
                      1: (0, 1, 2, 3, 5, 6, 7, 8, 9),
                      2: (0, 1, 2, 4, 5),
                      3: (0, 1, 2, 3, 4, 5),
                      4: (0, 2, 3, 4, 5)}


def bounded_population(seed: int, pop: int, skeleton) -> np.ndarray:
    """``[pop, L]`` int32 genomes over :data:`SEARCH_BOUNDED_OPS`."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(SEARCH_BOUNDED_OPS[k], pop)
                     for k in skeleton], axis=1).astype(np.int32)


def same_order(a: np.ndarray, b: np.ndarray, valid: np.ndarray
               ) -> np.ndarray:
    """Per candidate, whether two evaluations of its exposures
    ``[P, D, T]`` order the valid lanes of every date alike, ties
    included. The rank IC and the decile spread are step functions of
    that order: where two evaluations a few ulps apart order two nearly
    equal exposures apart (a mean of a day-constant series is rounded
    per ticker), they move by a step, not by an ulp."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    out = np.ones(a.shape[0], bool)
    for p in range(a.shape[0]):
        for d in range(a.shape[1]):
            v = valid[p, d] if valid.ndim == 3 else valid[d]
            x, y = a[p, d][v], b[p, d][v]
            ox, oy = np.argsort(x, kind="stable"), np.argsort(y, kind="stable")
            if not (np.array_equal(ox, oy) and np.array_equal(
                    np.diff(x[ox]) == 0, np.diff(y[oy]) == 0)):
                out[p] = False
                break
    return out


def make_batch(rng, n_days: int, n_tickers: int, session=None):
    """``bench.make_batch``'s recipe (the JAX package's headline batch):
    a close random walk in f32 draws, open/high/low around it,
    tick-aligned prices, board-lot volume, 2% missing bars. Returns f32
    bars ``[D, T, S, 5]`` and the bool mask."""
    from replication_of_minute_frequency_factor_tpu_torch.markets import (
        get_session)

    shape = (n_days, n_tickers,
             get_session(session if session is not None
                         else "cn_ashare_240").n_slots)
    close = (10.0 * np.exp(np.cumsum(
        rng.standard_normal(shape, dtype=np.float32) * np.float32(1e-3),
        axis=-1)))
    open_ = close * (1 + rng.standard_normal(shape, dtype=np.float32)
                     * np.float32(1e-4))
    high = np.maximum(open_, close) * 1.0002
    low = np.minimum(open_, close) * 0.9998
    volume = (rng.integers(0, 1000, shape) * 100).astype(np.float32)
    bars = np.stack([open_, high, low, close, volume], axis=-1)
    bars[..., :4] = np.round(bars[..., :4], 2)
    mask = rng.random(shape, dtype=np.float32) > 0.02
    return bars.astype(np.float32), mask


def encode_year(batches, use_wire: bool = True, max_passes: int = 4):
    """``bench.encode_year``: every batch encoded under ONE shared
    widen-only floor, passes repeated until all share one spec, so the
    packed buffers land on a single ``(spec, length)``. Returns
    ``(buffers, spec, kind)``; ``kind`` is ``'raw'`` when the wire cannot
    represent the year.

    ``batches`` is iterated once a pass and yields ``(bars, mask)``: a
    :class:`Year` makes each batch anew from its seed, so the year's f32
    bars are never all held at once; only the packed buffers are kept."""
    from replication_of_minute_frequency_factor_tpu_torch.data import wire

    if use_wire:
        floor: dict = {}
        encs = [wire.encode(b, m, floor=floor) for b, m in batches]
        for _ in range(max_passes):
            if not all(e is not None for e in encs):
                break
            packs = [wire.pack_arrays(e.arrays) for e in encs]
            if len({p[1] for p in packs}) == 1:
                return [p[0] for p in packs], packs[0][1], "wire"
            encs = [wire.encode(b, m, floor=floor) for b, m in batches]
    packs = [wire.pack_arrays((b, m.view(np.uint8))) for b, m in batches]
    return [p[0] for p in packs], packs[0][1], "raw"


class Year:
    """``n`` batches of :func:`make_batch`, batch ``i`` made from
    ``default_rng([seed, i])`` each time it is iterated (a sequence, so
    :func:`encode_year` can take several passes without holding the f32
    bars of more than one batch)."""

    def __init__(self, seed: int, n: int, n_days: int, n_tickers: int,
                 session=None):
        self.seed, self.n = seed, n
        self.n_days, self.n_tickers, self.session = (n_days, n_tickers,
                                                     session)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return make_batch(np.random.default_rng([self.seed, i]),
                          self.n_days, self.n_tickers, self.session)
