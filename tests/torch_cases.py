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


def _pad_year(batches, d_mult: int, t_mult: int):
    """Tickers padded with masked lanes to ``t_mult``, days with fully
    masked filler days to ``d_mult`` (``bench.encode_year_2d``'s
    padding). Returns ``(batches, t_pad, d_pad)``."""
    t = batches[0][0].shape[1]
    d = batches[0][0].shape[0]
    t_pad = -(-t // t_mult) * t_mult
    d_pad = -(-d // d_mult) * d_mult
    if t_pad != t or d_pad != d:
        pad_b = [(0, d_pad - d), (0, t_pad - t), (0, 0), (0, 0)]
        pad_m = [(0, d_pad - d), (0, t_pad - t), (0, 0)]
        batches = [(np.pad(b, pad_b), np.pad(m, pad_m))
                   for b, m in batches]
    return batches, t_pad, d_pad


def _encode_packed(batches, use_wire, pack, max_passes):
    """``bench.encode_year``'s shared-floor loop with ``pack(arrays)``
    as the packer: ``(packs, kind)``."""
    from replication_of_minute_frequency_factor_tpu_torch.data import wire

    if use_wire:
        floor: dict = {}
        encs = [wire.encode(b, m, floor=floor) for b, m in batches]
        for _ in range(max_passes):
            if not all(e is not None for e in encs):
                break
            packs = [pack(e.arrays) for e in encs]
            if len({p[1] for p in packs}) == 1:
                return packs, "wire"
            encs = [wire.encode(b, m, floor=floor) for b, m in batches]
    return [pack((b, m.view(np.uint8))) for b, m in batches], "raw"


def encode_year_sharded(batches, use_wire: bool, n_shards: int,
                        max_passes: int = 4, bucket: int = 1):
    """``bench.encode_year_sharded``: tickers padded with masked lanes to
    a multiple of lcm(bucket, n_shards), the shared widen-only floor,
    each batch packed as an ``[S, L]`` per-shard stack
    (``wire.pack_sharded``). Returns ``(stacks, spec, kind, t_pad)``."""
    from replication_of_minute_frequency_factor_tpu_torch.data import wire

    mult = int(bucket * n_shards // np.gcd(bucket, n_shards))
    batches, t_pad, _ = _pad_year(list(batches), 1, mult)
    packs, kind = _encode_packed(
        batches, use_wire, lambda a: wire.pack_sharded(a, n_shards),
        max_passes)
    return [p[0] for p in packs], packs[0][1], kind, t_pad


def encode_year_2d(batches, use_wire: bool, d_shards: int, t_shards: int,
                   max_passes: int = 4, bucket: int = 1):
    """``bench.encode_year_2d``: tickers padded to lcm(bucket, t_shards),
    days to a multiple of ``d_shards`` with fully masked filler days,
    each batch packed as a ``[Sd, St, L]`` per-tile stack. Returns
    ``(stacks, spec, kind, t_pad, d_pad)``."""
    from replication_of_minute_frequency_factor_tpu_torch.data import wire

    mult = int(bucket * t_shards // np.gcd(bucket, t_shards))
    batches, t_pad, d_pad = _pad_year(list(batches), d_shards, mult)
    packs, kind = _encode_packed(
        batches, use_wire,
        lambda a: wire.pack_sharded_2d(a, d_shards, t_shards), max_passes)
    return [p[0] for p in packs], packs[0][1], kind, t_pad, d_pad


# --------------------------------------------------------------------------
# checks on a group of ranks (tests/test_torch_parallel.py,
# test_torch_sharded_resident.py and chip_smoke.py's phase 14)
# --------------------------------------------------------------------------

def run_on_ranks(jobs, world: int, workdir=None, device="cpu",
                 timeout_s: float = 240.0, backend=None):
    """Every job of ``jobs`` (``[(name, kind, kwargs)]``) on ``world``
    spawned ranks of one process group, in order; returns one
    ``{name: result}`` a rank (results are host numpy, dicts of it, or
    plain values; they come back through files under ``workdir``)."""
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        launch)

    return launch.run_ranks(rank_jobs, world, args=(list(jobs),),
                            device=device, backend=backend,
                            timeout_s=timeout_s,
                            workdir=None if workdir is None
                            else str(workdir))


def rank_jobs(rank: int, jobs):
    out = {}
    for name, kind, kw in jobs:
        out[name] = globals()[f"job_{kind}"](rank, **kw)
    return out


def _host(x):
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def job_resident_1d(rank, stacks, spec, kind, names, device="cpu",
                    result_spec=None, factor_stats=False):
    """``compute_packed_resident_sharded`` on a ``(1, world)`` mesh over
    the host ``[N, S, L]`` year: this rank's output (and side outputs),
    its mesh coordinate, the launches of the tiled kernel."""
    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh, put_packed_year)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        get_telemetry)

    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)

    mesh = make_mesh(None, device)
    bufs = put_packed_year(np.stack(stacks), mesh)
    rolling_cuda.reset_launches()
    out = pipeline.compute_packed_resident_sharded(
        bufs, spec, kind, mesh, names, result_spec=result_spec,
        factor_stats=factor_stats)
    launches = dict(rolling_cuda.launches)
    get_telemetry().meshplane.drain()
    res = {"coord": mesh.coordinate, "backend": mesh.backend,
           "launches": launches}
    if factor_stats:
        res["ys"], res["stats"] = _host(out)
    else:
        res["ys"] = _host(out)
    return res


def job_resident_2d(rank, stacks, spec, kind, names, shape, group,
                    t_pad, device="cpu", factor_stats=False,
                    result_spec=None):
    """``compute_packed_resident_2d`` on a ``shape`` mesh over the host
    ``[N, Sd, St, L]`` year, ``group`` batches a call with the carry
    threaded between calls: this rank's tiles, its year-end carry, the
    carry-handoff dispatches counted and the mesh block."""
    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh, put_packed_year_2d, put_span_carry)
    from replication_of_minute_frequency_factor_tpu_torch.stream.carry import (
        init_span_state)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)

    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)

    tel = set_telemetry(Telemetry())
    mesh = make_mesh(tuple(shape), device)
    if isinstance(stacks, str):  # a .npy file: each rank reads its tiles
        stacks = np.load(stacks, mmap_mode="r")
    carry = put_span_carry(init_span_state(t_pad), mesh)
    rolling_cuda.reset_launches()
    ys, stats = [], []
    for g0 in range(0, len(stacks), group):
        grp = stacks[g0:g0 + group]
        bufs = put_packed_year_2d(
            grp if isinstance(grp, np.ndarray) else np.stack(grp), mesh)
        out = pipeline.compute_packed_resident_2d(
            bufs, spec, kind, mesh, names, carry_in=carry,
            factor_stats=factor_stats, result_spec=result_spec)
        carry = out[-1]
        ys.append(_host(out[0]))
        if factor_stats:
            stats.append(_host(out[1]))
    tel.meshplane.drain()
    return {"coord": mesh.coordinate, "ys": np.concatenate(ys),
            "stats": np.concatenate(stats) if stats else None,
            "carry": _host(carry),
            "handoffs": tel.registry.counter_value(
                "mesh.collective_dispatches", label="carry_handoff"),
            "launches": dict(rolling_cuda.launches),
            "mesh": tel.meshplane.summary()}


def job_donation(rank, stacks_1d, spec_1d, stacks_2d, spec_2d, kind,
                 names, t_pad):
    """The donation contract on both sharded loops, donation forced on
    (the CPU never donates): the handles are dead (any use raises
    DonatedBufferError), ``Config.debug_validate`` names the contract at
    the next entry, and the 2-D loop's carry stays usable."""
    from replication_of_minute_frequency_factor_tpu_torch import (
        config, pipeline)
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh, put_packed_year, put_packed_year_2d, put_span_carry)
    from replication_of_minute_frequency_factor_tpu_torch.stream.carry import (
        init_span_state)

    pipeline._donate_device_buffers = lambda cfg=None, device=None: True
    out = {}
    for label, shape, run in (
            ("1d", None, lambda m, b, c: pipeline.
             compute_packed_resident_sharded(b, spec_1d, kind, m, names)),
            ("2d", (2, 2), lambda m, b, c: pipeline.
             compute_packed_resident_2d(b, spec_2d, kind, m, names,
                                        carry_in=c))):
        mesh = make_mesh(shape, "cpu")
        bufs = (put_packed_year(np.stack(stacks_1d), mesh) if shape is None
                else put_packed_year_2d(np.stack(stacks_2d), mesh))
        carry = put_span_carry(init_span_state(t_pad), mesh)
        run(mesh, bufs, carry)
        res = {"dead": all(type(b).__name__ == "_DonatedTensor"
                           for b in bufs)}
        try:
            bufs[0].sum()
            res["use"] = "no error"
        except pipeline.DonatedBufferError as e:
            res["use"] = str(e)
        prev = config.get_config()
        config.set_config(config.Config(debug_validate=True))
        try:
            run(mesh, bufs, carry)
            res["guard"] = "no error"
        except pipeline.DonatedBufferError as e:
            res["guard"] = str(e)
        finally:
            config.set_config(prev)
        res["carry_usable"] = int(carry["n_bars"].sum()) == 0
        out[label] = res
    return out


def job_xs(rank, x, y, m, stats, n_pop, k):
    """The cross-sectional collectives on a ``(1, world)`` mesh over this
    rank's tickers of the host ``[dates, T]`` matrices; returns this
    rank's lanes (or the replicated values) of each."""
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        collectives as xc, make_mesh)
    from replication_of_minute_frequency_factor_tpu_torch.parallel.mesh import (
        local_slice)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)

    tel = set_telemetry(Telemetry())
    mesh = make_mesh(None, "cpu")
    spec = (None, "tickers")
    lx, ly, lm = (torch.from_numpy(local_slice(a, spec, mesh).copy())
                  for a in (x, y, m))
    out = {"coord": mesh.coordinate,
           "mean": xc.xs_masked_mean(mesh, lx, lm),
           "std": xc.xs_masked_std(mesh, lx, lm),
           "ic": xc.xs_pearson(mesh, lx, ly, lm),
           "rank": xc.xs_rank(mesh, lx, lm),
           "qcut": {g: xc.xs_qcut(mesh, lx, lm, group_num=g)
                    for g in (3, 5, 10)}}
    with mesh:
        flat = lambda a: a.reshape(1, -1)  # noqa: E731
        out["grank"] = xc.xs_global_rank_local(flat(lx), flat(lm))
        ls = torch.from_numpy(local_slice(stats, ("tickers", None),
                                          mesh).copy())
        out["topk"] = xc.xs_population_topk_local(ls, k, n_pop)
    out["dispatches"] = tel.registry.counter_total(
        "mesh.collective_dispatches")
    return _host(out)


def job_factors(rank, bars, mask, shape, names=None):
    """``shard_day_batch`` + ``sharded_compute_factors`` on a ``shape``
    mesh: this rank's ``{name: [D/d, T/t]}`` block, the DayContext rank
    of the block through the tickers axis, and the pad-waste gauge."""
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        DayContext)
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh, shard_day_batch, sharded_compute_factors)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)

    tel = set_telemetry(Telemetry())
    mesh = make_mesh(tuple(shape), "cpu")
    b, m, n_tickers = shard_day_batch(bars, mask, mesh)
    out = sharded_compute_factors(b, m, mesh, names=names)
    with mesh:
        grank = DayContext(b, m, xs_axis_name="tickers").eod_ret_global_rank
    return {"coord": mesh.coordinate, "n_tickers": n_tickers,
            "factors": _host(out), "grank": _host(grank),
            "pad_waste": tel.meshplane.summary()["pad_waste_frac_by_axis"]}


def job_multihost(rank, bars, mask):
    """The multihost layer inside a group: the topology gauges' values,
    the global mesh, and ``shard_from_host_local`` from this process's
    tickers slice."""
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        multihost)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)

    tel = set_telemetry(Telemetry())
    mesh = multihost.global_mesh(device="cpu")
    t = bars.shape[1] // mesh.size
    sl = slice(rank * t, (rank + 1) * t)
    b, m = multihost.shard_from_host_local(bars[:, sl], mask[:, sl], mesh)
    return {"index": multihost.process_index(),
            "count": multihost.process_count(),
            "shape": dict(mesh.shape), "coord": mesh.coordinate,
            "bars": _host(b), "mask": _host(m),
            "built": tel.registry.counter_total("multihost.shards_built")}


def job_handoff(rank, shape):
    """``xs_carry_handoff_local`` on a ``shape`` mesh: rank r offers a
    span state whose newest day is ``r`` on some lanes; every rank of a
    day axis must end with the fold over that axis."""
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh)
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        collectives as xc)
    from replication_of_minute_frequency_factor_tpu_torch.stream.carry import (
        combine_span_state)

    mesh = make_mesh(tuple(shape), "cpu")
    i = mesh.axis_index("days")
    has = torch.tensor([True, i % 2 == 0, False, i == 0])
    state = {"last_close": torch.tensor([1.0, 2.0, 3.0, 4.0]) * (i + 1),
             "n_bars": torch.tensor([10, 20, 30, 40], dtype=torch.int32)
             + i,
             "has": has,
             "day": torch.where(has, i, -1).to(torch.int32)}
    with mesh:
        out = xc.xs_carry_handoff_local(state, combine_span_state,
                                        "days", mesh.shape["days"])
    return {"coord": mesh.coordinate, "state": _host(out)}


def job_meshplane(rank):
    """``measure_ready_mesh`` on a ``(2, world/2)`` mesh: the flat and
    per-axis watermarks published on every rank."""
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)
    import torch.distributed as dist

    tel = set_telemetry(Telemetry())
    mesh = make_mesh((2, dist.get_world_size() // 2), "cpu")
    sample = tel.meshplane.measure_ready_mesh(torch.zeros(4), mesh,
                                              boundary="test")
    tel.meshplane.note_collective("probe")
    return {"sample": sample, "summary": tel.meshplane.summary()}


#: bench._ULP_FACTORS: the pair the JAX package holds at <= 16 f32 eps of
#: the scale between sharded and single-device runs (its sqrt/sqrt
#: division fuses by module shape); every other factor is held bitwise
ULP_FACTORS = ("vol_upRatio", "vol_downRatio")


def sharded_misses(names, got, want):
    """The sharded-vs-single-device bar per factor over ``[..., F, ...]``
    blocks (factor axis 1): bitwise, except :data:`ULP_FACTORS` (NaN
    pattern identical, finite values within 16 eps of the block's
    scale). Returns ``{name: largest gap}`` of the factors that miss."""
    eps = float(np.finfo(np.float32).eps)
    out = {}
    for j, n in enumerate(names):
        a, b = np.asarray(want[:, j]), np.asarray(got[:, j])
        if n in ULP_FACTORS:
            f = np.isfinite(a)
            scale = np.abs(a[f]).max(initial=1.0) or 1.0
            gap = float(np.abs(a[f] - b[f]).max(initial=0.0))
            if (not np.array_equal(np.isnan(a), np.isnan(b))
                    or not np.array_equal(np.isfinite(a), np.isfinite(b))
                    or gap > 16 * eps * scale):
                out[n] = gap
        elif not np.array_equal(np.ascontiguousarray(a).view(np.int32),
                                np.ascontiguousarray(b).view(np.int32)):
            f = np.isfinite(a) & np.isfinite(b)
            out[n] = float(np.abs(a[f] - b[f]).max(initial=0.0))
    return out


def _group_backends(mesh):
    import torch.distributed as dist
    return {ax: (None if mesh.group(ax) is None
                 else str(dist.get_backend(mesh.group(ax))))
            for ax in ("days", "tickers")}


def job_year_1d(rank, path, spec, kind, names, n_logical, rspec=None,
                device="cuda"):
    """A resident year's ``[N, S, L]`` stack (a .npy file; each rank
    reads its own shard) through ``compute_packed_resident_sharded`` on a
    ``(1, world)`` mesh on the card: the raw run under
    ``torch.cuda.set_sync_debug_mode('error')`` (the transport's staging
    waits counted apart), its launches, walls and donated handles; then
    the result wire and the stats on fresh copies."""
    import time

    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh, put_packed_year)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)

    tel = set_telemetry(Telemetry())
    mesh = make_mesh(None, device)
    stacked = np.load(path, mmap_mode="r")
    bufs = put_packed_year(stacked, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rolling_cuda.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        ys = pipeline.compute_packed_resident_sharded(
            bufs, spec, kind, mesh, names, rolling_impl="cuda")
        t_enqueue = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = dict(rolling_cuda.launches)
    waits = tel.registry.counter_total("mesh.staged_host_waits")
    torch.cuda.synchronize()
    t_done = time.perf_counter() - t0
    host = ys.cpu().numpy()
    dead = all(type(b).__name__ == "_DonatedTensor" for b in bufs)
    try:
        bufs[0].sum()
        reuse = "no error"
    except pipeline.DonatedBufferError as e:
        reuse = str(e)
    del ys, bufs
    side = {}
    if rspec is not None:
        fresh = put_packed_year(stacked, mesh)
        rolling_cuda.reset_launches()
        payload, stats = pipeline.compute_packed_resident_sharded(
            fresh, spec, kind, mesh, names, rolling_impl="cuda",
            result_spec=rspec, factor_stats=n_logical)
        side = {"payload": payload.cpu().numpy(),
                "stats": stats.cpu().numpy(),
                "launches": dict(rolling_cuda.launches)}
    tel.meshplane.drain()
    return {"coord": mesh.coordinate, "backends": _group_backends(mesh),
            "ys": host, "launches": launches, "staged_waits": waits,
            "enqueue_s": t_enqueue, "done_s": t_done, "dead": dead,
            "reuse": reuse, "peak": torch.cuda.max_memory_allocated(),
            "side": side, "mesh": tel.meshplane.summary()}


def job_exposures_in_group(rank, minute_dir, names, cache_path,
                           fail_rank=None, gather_faults=0):
    """``compute_exposures(mesh_shape=(1, world))`` on every rank of the
    group, as under torchrun; ``fail_rank``'s first step raises once
    its collectives are done, or, with ``gather_faults`` = k, its first
    k ``doc_pdf*`` rank gathers raise before they gather. Rank 0's table
    columns, failed days, retries and batch isolations; None on the
    others."""
    import torch.distributed as dist

    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    from replication_of_minute_frequency_factor_tpu_torch.config import (
        Config)
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        collectives)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry)

    if rank == fail_rank and gather_faults:
        real_rank, faults = collectives.xs_global_rank_local, []

        def failing(*args, **kw):
            if len(faults) < gather_faults:
                faults.append(1)
                raise RuntimeError("injected fault before the gather")
            return real_rank(*args, **kw)

        collectives.xs_global_rank_local = failing
    elif rank == fail_rank:
        real, calls = pipeline._packed_step, []

        def flaky(*args, **kw):
            out = real(*args, **kw)
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected fault on this rank")
            return out

        pipeline._packed_step = flaky
    tel = Telemetry()
    out = pipeline.compute_exposures(
        minute_dir, names, cache_path=cache_path,
        cfg=Config(days_per_batch=2, mesh_shape=(1, dist.get_world_size())),
        progress=False, telemetry=tel, device="cpu")
    if out is None:
        return None
    return {"columns": out.columns, "failures": sorted(out.failures.keys()),
            "retries": tel.registry.counter_total("pipeline.retries"),
            "isolations": tel.registry.counter_total(
                "pipeline.batch_isolations")}


def job_nccl_probe(rank):
    """One all-reduce on the default group: does the transport take these
    ranks (NCCL refuses two ranks on one card)?"""
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    return {"backend": str(dist.get_backend()), "sum": x.cpu().tolist()}


def job_nccl_year(rank, path, spec, kind, names, rspec=None,
                  n_logical=None):
    """A one-rank NCCL mesh whose tickers axis is the WORLD group (an
    axis of one rank has no group of its own, and its collectives would
    be the identity): the transport's collectives on the card's tensors
    under ``set_sync_debug_mode('error')`` (no staging, no host wait),
    and the sharded loop over the year's one shard, raw and with the
    side outputs, its gathers and reductions all through NCCL."""
    import torch.distributed as dist

    from replication_of_minute_frequency_factor_tpu_torch import pipeline
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        make_mesh, put_packed_year, transport)
    from replication_of_minute_frequency_factor_tpu_torch.parallel.mesh import (
        TICKERS_AXIS, Mesh)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)

    world = dist.group.WORLD

    class WorldTickersMesh(Mesh):
        def group(self, axis):
            return world if axis == TICKERS_AXIS else super().group(axis)

    tel = set_telemetry(Telemetry())
    mesh = make_mesh((1, 1), "cuda")
    mesh.__class__ = WorldTickersMesh
    x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(3, 4)
    m = x > 3
    # the communicator is made at the first collective: outside the check
    transport.all_reduce(torch.zeros(1, device="cuda"), dist.ReduceOp.SUM,
                         world)
    torch.cuda.synchronize()
    calls = {"all_gather": 0, "all_reduce": 0}
    real = {k: getattr(transport, k) for k in calls}

    def counted(name):
        def run(*args, **kw):
            calls[name] += 1
            return real[name](*args, **kw)
        return run

    year = np.load(path, mmap_mode="r")
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = transport.all_gather(x, world)
        gm = transport.all_gather(m, world)
        r = transport.all_reduce(x, dist.ReduceOp.MIN, world)
        for k in calls:
            setattr(transport, k, counted(k))
        ys = pipeline.compute_packed_resident_sharded(
            put_packed_year(year, mesh), spec, kind, mesh, names,
            rolling_impl="cuda")
        loop = dict(calls)
        side = None
        if rspec is not None:
            side = pipeline.compute_packed_resident_sharded(
                put_packed_year(year, mesh), spec, kind, mesh, names,
                rolling_impl="cuda", result_spec=rspec,
                factor_stats=n_logical)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for k in calls:
            setattr(transport, k, real[k])
    out = {"backend": str(dist.get_backend(world)),
           "gather_ok": bool(torch.equal(g, x) and torch.equal(gm, m)
                             and torch.equal(r, x)),
           "staged_waits": tel.registry.counter_total(
               "mesh.staged_host_waits"),
           "loop_collectives": loop, "collectives": dict(calls),
           "ys": ys.cpu().numpy()}
    if side is not None:
        out["payload"], out["stats"] = (t.cpu().numpy() for t in side)
    return out
