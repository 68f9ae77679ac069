"""Batched symbolic factor search (BASELINE.json config 5).

The port of the JAX package's ``search.py``. It searches the space of factor
expressions over the minute-bar day tensor by evaluating a whole
*population* of candidate expression programs at once: the genome is data,
not Python code, so thousands of candidates batch onto the card instead of
running thousands of interpreter passes.

Representation: every candidate shares a fixed postfix *skeleton* (a static
sequence of typed slots, so stack discipline is valid by construction).
Stack entries are (series, validity-mask) pairs over the minute axis; a
genome assigns each slot a choice:

  PUSH   -> which per-bar feature series to push (open/.../volume, intrabar
            return, volume share, hl-range, tod ramp; cross-day state:
            overnight gap, prev-day return, volume over prev-day total —
            NaN on day 0, like pct_change().over('code')'s first row),
            with the day mask
  UNARY  -> identity / neg / abs / log1p|x| / zscore over valid bars /
            lag-1 / cumsum / delta-1 / rolling mean (5, 30) / rolling
            std (5, 30) — windowed ops run masked over the minute axis
  BINARY -> + / - / * / protected divide / min / max / rolling corr (30);
            the result mask is the operands' intersection
  MASK   -> restrict the validity mask: AM session / PM session / first 30
            minutes / last 30 minutes (the reference's time sentinels,
            e.g. MinuteFrequentFactorCalculateMethodsCICC.py:18,770) /
            positive values / negative values (its conditional-volatility
            split, :537-560)
  AGG    -> reduce the series to a per-(day, ticker) scalar — mean / std /
            sum / last / max / min — pushed back as a constant series so
            aggregates compose through BINARY (ratio-of-stds factors like
            vol_upRatio, :563-588)

The factor value per (candidate, day, ticker) is the masked mean of the
final entry under its own mask; fitness is |mean per-date cross-sectional
Pearson IC| against caller-supplied forward returns. Selection, mutation
and crossover run on the host on the int genome matrix; only evaluation
touches the device.

The per-candidate choice at each slot. The JAX package ``vmap``s one
program over the population, and a slot's choice becomes a ``jnp.select``
over every branch of the slot's op table, which XLA evaluates for every
candidate. Eager torch has no compiler to drop the dead branches, so an
all-branch evaluation would cost about ten times the memory traffic of the
branch each candidate takes. The genome matrix is host data in every
caller, so the port groups a population's candidates by their choice at
each slot on the host and runs each op only on the candidates that chose
it (an ``index_select``, the op, an ``index_copy_``; a slot where every
candidate made the same choice runs the op on the whole population with no
gather). Each candidate's values are independent of the others', so the
grouped result is the all-branch select's, bit for bit on the CPU
(tests/test_torch_search.py). The index lists of a whole population go to
the device in one copy from pinned memory, never waited for.

Genomes are host data (numpy or a CPU tensor); ``bars``/``mask`` are
tensors on the device the evaluation runs on, or numpy arrays, which go to
``device`` (default ``cuda``, which must be present; ``device='cpu'`` runs
on the CPU), as in ``pipeline.compute_batch``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.minute import F_CLOSE, F_HIGH, F_LOW, F_OPEN, F_VOLUME
from .ops import (masked_corr, masked_first, masked_last, masked_max,
                  masked_mean, masked_min, masked_std, masked_sum)

# slot kinds
PUSH, UNARY, BINARY, MASK, AGG = 0, 1, 2, 3, 4

#: default skeleton: (((f u) (f u) b u) ((f) (f) b) b u) — depth-3 tree,
#: 6 feature leaves worth of mixing, 15 slots
DEFAULT_SKELETON: Tuple[int, ...] = (
    PUSH, UNARY, PUSH, UNARY, BINARY, UNARY,
    PUSH, PUSH, BINARY,
    BINARY,
    PUSH, PUSH, BINARY,
    BINARY, UNARY,
)

#: ratio-of-aggregates skeleton: agg(mask(u(f))) ⊘ agg(u(f)) — the shape
#: of the reference's conditional-volatility family (vol_upRatio ==
#: std(ret | ret > 0) / std(ret), MinuteFrequentFactorCalculate
#: MethodsCICC.py:563-588), reachable by the genome as
#: (ret, id, pos, std, ret, id, std, /)
RICH_SKELETON: Tuple[int, ...] = (
    PUSH, UNARY, MASK, AGG,
    PUSH, UNARY, AGG,
    BINARY,
)

N_FEATURES = 12
N_UNARY = 12
N_BINARY = 7
N_MASK = 6
N_AGG = 6

_KIND_SIZES = {PUSH: N_FEATURES, UNARY: N_UNARY, BINARY: N_BINARY,
               MASK: N_MASK, AGG: N_AGG}

#: rolling windows baked into the unary/binary op tables
ROLL_FAST, ROLL_SLOW = 5, 30

_NAN = float("nan")


def _prev_day(x):
    """Shift a per-(day, ticker) aggregate to the NEXT day along the
    leading (trading-day) axis; day 0 gets NaN — the cross-day analogue
    of the reference's null-on-first-row ``pct_change().over('code')``
    (MinuteFrequentFactorCalculateMethodsCICC.py:746)."""
    return torch.cat([torch.full_like(x[:1], _NAN), x[:-1]], dim=0)


def tod_ramp(n_slots: int, device=None) -> torch.Tensor:
    """The ``tod`` feature, ``jnp.linspace(-1.0, 1.0, n_slots)`` as every
    jitted JAX evaluation sees it, bit for bit: XLA evaluates the
    linspace's ``iota / div`` as ``iota * f32(1 / div)`` and then
    ``-(1 - step) + step``, each rounded to f32. ``torch.linspace`` is an
    ulp off at some points, and so is an eager ``jnp.linspace``. Built
    on the device with separate ops (no copy from the host)."""
    div = n_slots - 1
    inv = float(np.float32(1) / np.float32(div))
    step = torch.arange(div, dtype=torch.float32, device=device) * inv
    ramp = step - (1.0 - step)
    return torch.cat([ramp, torch.ones(1, device=device)])


def _features(bars, mask):
    """Feature bank ``[F, D, T, S]`` of per-bar series.

    The leading bars axis is the trading-day axis (consecutive days,
    sorted): the three cross-day features (overnight gap, previous-day
    intraday return, volume relative to the previous day's total) shift
    per-day aggregates along it. Day 0 — and any (day, ticker) whose
    previous day has no valid bars — carries NaN there, which the
    fitness path already treats as invalid.
    """
    o = bars[..., F_OPEN]
    h = bars[..., F_HIGH]
    l = bars[..., F_LOW]
    c = bars[..., F_CLOSE]
    v = bars[..., F_VOLUME]
    eps = 1e-12
    ret = (c - o) / torch.where(o.abs() > eps, o, 1.0)
    vol_day = torch.where(mask, v, 0.0).sum(dim=-1, keepdim=True)
    vshare = v / vol_day.clamp(min=1.0)
    hlr = (h - l) / torch.where(l.abs() > eps, l, 1.0)
    tod = tod_ramp(bars.shape[-2], bars.device).expand(mask.shape)
    # cross-day state ([D, T] aggregates, broadcast back to the bar axis)
    day_open = masked_first(o, mask)
    day_close = masked_last(c, mask)
    prev_close = _prev_day(day_close)
    gap = torch.where(prev_close.abs() > eps,
                      day_open / prev_close - 1.0, _NAN)
    prev_ret = _prev_day(torch.where(day_open.abs() > eps,
                                     day_close / day_open - 1.0, _NAN))
    # NaN (not 0) when the previous day has no valid bars, so a fully
    # halted prev day makes vprev invalid like gap/prev_ret — 0 would
    # turn vprev into today's RAW volume, an out-of-distribution value
    # the GA could exploit
    prev_vol = _prev_day(torch.where(mask.any(dim=-1), vol_day[..., 0],
                                     _NAN))
    vprev = v / prev_vol[..., None].clamp(min=1.0)
    return torch.stack([o, h, l, c, v, ret, vshare, hlr, tod,
                        gap[..., None].expand(mask.shape),
                        prev_ret[..., None].expand(mask.shape),
                        vprev])


#: the block of XLA's CPU prefix sum (its reduce-window rewriter): each
#: block of 16 slots is summed from its start, and each block then adds the
#: running total of the blocks before it (that scan blocked alike)
SCAN_BLOCK = 16


def prefix_sum(x):
    """Inclusive prefix sum along the last axis.

    On the CPU, in the association of the JAX package's ``jnp.cumsum`` on
    the CPU (:data:`SCAN_BLOCK`), with f32 adds: bit for bit JAX's, which
    the tests hold the port to. ``torch.cumsum`` accumulates in f64 on the
    CPU, and a windowed sum is a difference of two prefix sums, so its
    rounding decides whether a degenerate window's variance is 0 or a
    small positive number (``rolling_std`` 0 or ~1e-4, ``rolling_corr`` 0
    or +-1). On the card, ``torch.cumsum`` (one parallel scan): the
    blocked association costs ~30 launches a scan, and the generation is
    bound by launches; the card's windowed sums differ from the CPU's by
    rounding (tests/test_torch_cuda.py holds the card to the CPU on ops
    whose conditioning is bounded)."""
    if x.device.type != "cpu":
        return torch.cumsum(x, dim=-1)
    n = x.shape[-1]
    nb = -(-n // SCAN_BLOCK)
    if nb * SCAN_BLOCK != n:
        x = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n))
    # [B, ..., nb]: slot-in-block leading, so each step is one whole slice
    xb = x.reshape(x.shape[:-1] + (nb, SCAN_BLOCK)).movedim(-1, 0).clone(
        memory_format=torch.contiguous_format)
    for i in range(1, SCAN_BLOCK):
        torch.add(xb[i - 1], xb[i], out=xb[i])
    if nb > 1:
        run = prefix_sum(xb[-1])  # the blocks' running totals
        xb[..., 1:] += run[..., :-1]
    return xb.movedim(0, -1).reshape(x.shape[:-1] + (nb * SCAN_BLOCK,))[
        ..., :n]


def _windowed_sum(x, w):
    """Trailing-window sum over the minute axis (window w, causal), as
    the difference of two prefix sums (the JAX package's formulation).
    Several series stacked on a leading axis share one scan's launches."""
    cs = prefix_sum(x)
    return cs - torch.cat([torch.zeros_like(cs[..., :w]), cs[..., :-w]],
                          dim=-1)


def rolling_mean(x, m, w):
    """Masked trailing mean over ``w`` minute slots; 0 where the window
    holds no valid bars (mask is unchanged — windowed ops smooth the
    series, they do not invalidate lanes)."""
    s = _windowed_sum(torch.where(m, x, 0.0), w)
    n = _windowed_sum(m.to(x.dtype), w)
    return torch.where(n > 0, s / n.clamp(min=1.0), 0.0)


def rolling_std(x, m, w):
    """Masked trailing std (ddof=0) over ``w`` slots; 0 where the window
    holds no valid bars. The series is centred on its day mean first:
    one-pass E[x^2]-E[x]^2 in f32 on raw ~10-CNY prices cancels
    catastrophically."""
    xc = torch.where(m, x - masked_mean(x, m)[..., None], 0.0)
    n = _windowed_sum(m.to(x.dtype), w)
    nn = n.clamp(min=1.0)
    s1, s2 = _windowed_sum(torch.stack([xc, xc * xc]), w)
    mu = s1 / nn
    m2 = s2 / nn
    return torch.sqrt((m2 - mu * mu).clamp(min=0.0))


def rolling_corr(a, b, m, w):
    """Masked trailing Pearson over ``w`` slots; 0 where degenerate
    (either variance 0, or fewer than 2 valid bars in the window), NaN
    where an input is NaN. Day-mean centring as in :func:`rolling_std`."""
    ac = torch.where(m, a - masked_mean(a, m)[..., None], 0.0)
    bc = torch.where(m, b - masked_mean(b, m)[..., None], 0.0)
    n = _windowed_sum(m.to(a.dtype), w)
    nn = n.clamp(min=1.0)
    sums = _windowed_sum(torch.stack([ac, bc, ac * bc, ac * ac, bc * bc]),
                         w) / nn
    sa, sb, sab, saa, sbb = sums
    cov = sab - sa * sb
    va = (saa - sa * sa).clamp(min=0.0)
    vb = (sbb - sb * sb).clamp(min=0.0)
    denom = torch.sqrt(va * vb)
    ok = (denom > 0) & (n > 1.5)
    r = torch.where(ok, cov / torch.where(ok, denom, 1.0), 0.0)
    r = r.clamp(-1.0, 1.0)  # f32 noise can push an exact fit past 1
    # NaN inputs (cross-day features on day 0 / halted-prev-day lanes)
    # make cov/denom NaN, which the ok gate would otherwise launder to a
    # finite 0 — the one op family where NaN wouldn't propagate
    return torch.where(torch.isnan(cov) | torch.isnan(denom), _NAN, r)


def _zscore(x, m):
    mu = masked_mean(x, m)[..., None]
    sd = masked_std(x, m)[..., None]
    return (x - mu) / torch.where(sd > 0, sd, 1.0)


def _lag(x):
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def _protected_div(a, b):
    eps = 1e-6
    return a / torch.where(b.abs() > eps, b,
                           torch.where(b >= 0, eps, -eps))


#: the unary op table: ``op(x, m) -> [k, D, T, S]`` (index = gene value)
UNARY_OPS = (
    lambda x, m: x,
    lambda x, m: -x,
    lambda x, m: x.abs(),
    lambda x, m: torch.log1p(x.abs()),
    _zscore,
    lambda x, m: _lag(x),
    lambda x, m: prefix_sum(torch.where(m, x, 0.0)),
    lambda x, m: x - _lag(x),
    lambda x, m: rolling_mean(x, m, ROLL_FAST),
    lambda x, m: rolling_mean(x, m, ROLL_SLOW),
    lambda x, m: rolling_std(x, m, ROLL_FAST),
    lambda x, m: rolling_std(x, m, ROLL_SLOW),
)

#: the binary op table: ``op(a, b, m) -> [k, D, T, S]``
BINARY_OPS = (
    lambda a, b, m: a + b,
    lambda a, b, m: a - b,
    lambda a, b, m: a * b,
    lambda a, b, m: _protected_div(a, b),
    lambda a, b, m: torch.minimum(a, b),
    lambda a, b, m: torch.maximum(a, b),
    lambda a, b, m: rolling_corr(a, b, m, ROLL_SLOW),
)


def _slot_index(mask):
    """Minute-slot index [0, S) along the last axis."""
    return torch.arange(mask.shape[-1], device=mask.device)


#: the mask-restriction table: ``op(x, m) -> mask``; values pass through
#: untouched. Slots mirror the reference's hard-coded time sentinels
#: (AM/PM split at 11:30, first/last half hour) and its conditional value
#: splits (positive/negative returns).
MASK_OPS = (
    lambda x, m: m & (_slot_index(m) < 120),            # AM session
    lambda x, m: m & (_slot_index(m) >= 120),           # PM session
    lambda x, m: m & (_slot_index(m) < 30),             # first 30 minutes
    lambda x, m: m & (_slot_index(m) >= m.shape[-1] - 30),  # last 30
    lambda x, m: m & (x > 0),                           # positive values
    lambda x, m: m & (x < 0),                           # negative values
)

#: the aggregate table: ``op(x, m) -> [k, D, T]``; NaN where no valid bars
#: (masked_* semantics), so a halted ticker stays NaN end to end
AGG_OPS = (
    masked_mean,
    masked_std,
    masked_sum,
    lambda x, m: masked_last(x, m.expand(x.shape)),  # a gather: same rank
    masked_max,
    masked_min,
)

_OPS = {UNARY: UNARY_OPS, BINARY: BINARY_OPS, MASK: MASK_OPS, AGG: AGG_OPS}


# --- the population plan ---------------------------------------------------


def _host_genomes(genomes) -> np.ndarray:
    if isinstance(genomes, torch.Tensor):
        if genomes.device.type != "cpu":
            raise TypeError("genomes are host data: pass a numpy array or "
                            "a CPU tensor, not a tensor on "
                            f"{genomes.device}")
        genomes = genomes.numpy()
    g = np.ascontiguousarray(genomes, np.int32)
    if g.ndim != 2:
        raise ValueError(f"genomes must be [P, L]; got {g.shape}")
    return g


def slot_groups(genomes: np.ndarray, skeleton) -> List:
    """The host plan of one population: per slot, the PUSH column as
    feature indices, or for an op slot the ``(choice, rows)`` groups of the
    candidates that chose each op (``rows`` None when every candidate made
    the same choice)."""
    plan = []
    for slot, kind in enumerate(skeleton):
        col = genomes[:, slot]
        if kind == PUSH:
            first = int(col[0])
            plan.append(first if (col == first).all()
                        else col.astype(np.int64))
            continue
        choices = np.unique(col)
        if len(choices) == 1:
            plan.append([(int(choices[0]), None)])
        else:
            plan.append([(int(k), np.flatnonzero(col == k))
                         for k in choices])
    return plan


def upload_plans(plans: Sequence[List], device) -> List[List]:
    """Move the index arrays of several host plans to ``device`` in ONE
    copy (from pinned memory, not waited for, on the card); returns the
    plans with device index tensors in their place."""
    host = []
    for plan in plans:
        for entry in plan:
            if isinstance(entry, np.ndarray):
                host.append(entry)
            elif isinstance(entry, list):
                host.extend(rows for _, rows in entry if rows is not None)
    if not host:
        return [list(p) for p in plans]
    flat = torch.from_numpy(np.concatenate(host).astype(np.int64))
    device = torch.device(device)
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    else:
        flat = flat.to(device)
    out, at = [], 0

    def take(n):
        nonlocal at
        view = flat[at:at + n]
        at += n
        return view

    for plan in plans:
        dev_plan = []
        for entry in plan:
            if isinstance(entry, np.ndarray):
                dev_plan.append(take(len(entry)))
            elif isinstance(entry, list):
                dev_plan.append([(k, None if rows is None
                                  else take(len(rows)))
                                 for k, rows in entry])
            else:
                dev_plan.append(entry)
        out.append(dev_plan)
    return out


def _rows(t, idx, full_dim: int):
    """The candidates ``idx`` of a per-candidate tensor; a shared (day)
    mask, one dimension short, is every candidate's."""
    return t.index_select(0, idx) if t.dim() == full_dim else t


def _apply(ops, groups, args, m, p: int, masks: bool = False):
    """Run a slot's op per group of candidates and scatter the results
    back into candidate order (one op call when the slot has one
    choice). ``masks``: the ops are mask restrictions, whose result is
    the shared day mask's shape where they read no value."""
    if len(groups) == 1:
        k, _ = groups[0]
        return ops[k](*args, m)
    full = args[0].dim()
    out = None
    for k, idx in groups:
        r = ops[k](*(a.index_select(0, idx) for a in args),
                   _rows(m, idx, full))
        if masks and r.dim() < full:  # a time mask of a shared mask
            r = r.expand((len(idx),) + tuple(r.shape))
        if out is None:
            out = r.new_empty((p,) + tuple(r.shape[1:]))
        out.index_copy_(0, idx, r)
    return out


def evaluate_plan(plan, feats, mask, skeleton, p: int):
    """Run one population's device plan over a feature bank: ``[p, D, T]``
    factor values (masked mean of each candidate's final series under its
    own final mask; NaN where that mask is empty)."""
    tail = tuple(mask.shape)
    stack = []  # entries: (series [p, *tail], mask [*tail] or [p, *tail])
    for slot, kind in enumerate(skeleton):
        entry = plan[slot]
        if kind == PUSH:
            if isinstance(entry, int):
                x = feats[entry].expand((p,) + tail)
            else:
                x = feats.index_select(0, entry)
            stack.append((x, mask))
        elif kind == UNARY:
            x, m = stack.pop()
            stack.append((_apply(UNARY_OPS, entry, (x,), m, p), m))
        elif kind == BINARY:
            xb, mb = stack.pop()
            xa, ma = stack.pop()
            m = ma & mb
            stack.append((_apply(BINARY_OPS, entry, (xa, xb), m, p), m))
        elif kind == MASK:
            x, m = stack.pop()
            stack.append((x, _apply(MASK_OPS, entry, (x,), m, p,
                                     masks=True)))
        elif kind == AGG:
            x, m = stack.pop()
            s = _apply(AGG_OPS, entry, (x,), m, p)  # [p, D, T]
            # push back as a constant series under the DAY mask so
            # aggregates compose through BINARY with real series
            stack.append((s[..., None].expand((p,) + tail), mask))
        else:
            raise ValueError(f"unknown slot kind {kind}")
    if len(stack) != 1:
        raise ValueError("malformed skeleton")
    x, m = stack[0]
    return masked_mean(x, m)  # [p, D, T]


def _to_device(bars, mask, device):
    """``bars``/``mask`` as f32/bool tensors on their device (tensors) or
    on ``device`` (numpy; default ``cuda``)."""
    from .pipeline import resolve_device
    if isinstance(bars, np.ndarray):
        bars = torch.from_numpy(np.ascontiguousarray(bars, np.float32))
        bars = bars.to(resolve_device(device))
    elif device is not None:
        bars = bars.to(resolve_device(device))
    if isinstance(mask, np.ndarray):
        mask = torch.from_numpy(np.ascontiguousarray(mask, bool))
    return bars.to(torch.float32), mask.to(device=bars.device,
                                           dtype=torch.bool)


def eval_programs(genomes, bars, mask,
                  skeleton: Tuple[int, ...] = DEFAULT_SKELETON,
                  device=None):
    """Evaluate a genome population over a day batch.

    genomes: int ``[P, L]`` host array; bars ``[D, T, S, 5]``; mask
    ``[D, T, S]``. Returns factor values ``[P, D, T]`` on the bars' device
    (masked mean of each candidate's final series under its own final
    mask; NaN where that mask is empty — halted tickers, or a MASK chain
    that filtered everything out).
    """
    g = _host_genomes(genomes)
    bars, mask = _to_device(bars, mask, device)
    feats = _features(bars, mask)  # [F, D, T, S]
    plan, = upload_plans([slot_groups(g, skeleton)], bars.device)
    return evaluate_plan(plan, feats, mask, skeleton, len(g))


#: auto-chunk budget (the JAX package's): cap each population chunk's
#: ``[chunk, D, T, S]`` stack temporaries at this many f32 elements
#: (32M = 128 MB each)
_CHUNK_ELEMS = 32 * 1024 * 1024


def auto_chunk(mask_shape) -> int:
    """Largest population chunk whose ``[chunk, *mask_shape]`` stack
    temporaries stay inside the ``_CHUNK_ELEMS`` budget."""
    per_candidate = int(np.prod(mask_shape))
    return max(1, _CHUNK_ELEMS // per_candidate)


def chunk_bounds(p_total: int, chunk: int) -> List[Tuple[int, int]]:
    """``[start, stop)`` of each population chunk; the last one is
    short where ``chunk`` does not divide the population (each
    candidate's values do not depend on its neighbours, so a short
    chunk gives the padded chunk's values)."""
    return [(s, min(s + chunk, p_total)) for s in range(0, p_total, chunk)]


def fitness(genomes, bars, mask, fwd_ret, fwd_valid,
            skeleton: Tuple[int, ...] = DEFAULT_SKELETON,
            chunk: Optional[int] = None, device=None):
    """|mean per-date cross-sectional IC| per candidate -> ``[P]``.

    Large populations evaluate chunk by chunk so device temporaries stay
    bounded; ``chunk=None`` picks the largest chunk whose temporaries fit
    the budget from the day-tensor shape.
    """
    g = _host_genomes(genomes)
    bars, mask = _to_device(bars, mask, device)
    dev = bars.device
    fwd_ret = torch.as_tensor(fwd_ret, dtype=torch.float32, device=dev)
    fwd_valid = torch.as_tensor(fwd_valid, dtype=torch.bool, device=dev)
    if chunk is None:
        chunk = auto_chunk(mask.shape)
    feats = _features(bars, mask)
    bounds = chunk_bounds(len(g), chunk)
    plans = upload_plans([slot_groups(g[a:b], skeleton)
                          for a, b in bounds], dev)
    out = []
    for (a, b), plan in zip(bounds, plans):
        vals = evaluate_plan(plan, feats, mask, skeleton, b - a)
        valid = torch.isfinite(vals) & fwd_valid
        ic = masked_corr(torch.where(valid, vals, 0.0),
                         torch.where(valid, fwd_ret, 0.0).expand_as(vals),
                         valid)  # [p, D]
        out.append(torch.nanmean(ic, dim=-1).abs())
    return torch.cat(out)


def _gene_bounds(skeleton):
    return np.array([_KIND_SIZES[k] for k in skeleton], np.int32)


@dataclasses.dataclass
class SearchResult:
    genome: np.ndarray
    fitness: float
    history: np.ndarray  # best fitness per generation


def random_population(rng: np.random.Generator, pop: int,
                      skeleton=DEFAULT_SKELETON) -> np.ndarray:
    bounds = _gene_bounds(skeleton)
    return (rng.random((pop, len(skeleton))) * bounds).astype(np.int32)


def evolve(bars, mask, fwd_ret, fwd_valid,
           pop: int = 1024, generations: int = 10,
           elite_frac: float = 0.1, mutate_p: float = 0.15,
           skeleton=DEFAULT_SKELETON, seed: int = 0,
           device_batch: int = 1024,
           rng: Optional[np.random.Generator] = None,
           device=None) -> SearchResult:
    """Host-side GA around the device fitness.

    Tournament-free truncation GA: keep the elite, refill with uniform
    crossover of elite pairs + per-gene mutation. Each generation is one
    fitness call, chunked at ``min(device_batch, auto_chunk)``. ``rng``
    threads ONE explicit ``np.random.Generator`` through population init,
    crossover and mutation; ``seed`` seeds a fresh one when it is absent.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    bounds = _gene_bounds(skeleton)
    genomes = random_population(rng, pop, skeleton)
    n_elite = max(2, int(pop * elite_frac))
    history = []
    best_g, best_f = genomes[0], -1.0

    bars, mask = _to_device(bars, mask, device)
    chunk = min(device_batch, auto_chunk(tuple(mask.shape)))
    for _ in range(generations):
        fits = fitness(genomes, bars, mask, fwd_ret, fwd_valid,
                       skeleton=skeleton, chunk=chunk).cpu().numpy()
        fits = np.nan_to_num(fits, nan=-1.0)
        order = np.argsort(-fits)
        if fits[order[0]] > best_f:
            best_f = float(fits[order[0]])
            best_g = genomes[order[0]].copy()
        history.append(fits[order[0]])
        elite = genomes[order[:n_elite]]
        # refill: uniform crossover of random elite pairs + mutation
        pa = elite[rng.integers(0, n_elite, pop - n_elite)]
        pb = elite[rng.integers(0, n_elite, pop - n_elite)]
        take = rng.random(pa.shape) < 0.5
        children = np.where(take, pa, pb)
        mut = rng.random(children.shape) < mutate_p
        children = np.where(
            mut, (rng.random(children.shape) * bounds).astype(np.int32),
            children)
        genomes = np.concatenate([elite, children])

    return SearchResult(genome=best_g, fitness=best_f,
                        history=np.asarray(history))


FEAT_NAMES = ["open", "high", "low", "close", "vol", "ret", "vshare",
              "hlr", "tod", "gap", "prev_ret", "vprev"]
UNARY_NAMES = ["id", "neg", "abs", "log1p", "z", "lag1", "cumsum",
               "delta1", f"rmean{ROLL_FAST}", f"rmean{ROLL_SLOW}",
               f"rstd{ROLL_FAST}", f"rstd{ROLL_SLOW}"]
BINARY_NAMES = ["+", "-", "*", "/", "min", "max", f"rcorr{ROLL_SLOW}"]
MASK_NAMES = ["am", "pm", "first30", "last30", "pos", "neg"]
AGG_NAMES = ["mean", "std", "sum", "last", "max", "min"]


def describe(genome, skeleton=DEFAULT_SKELETON) -> str:
    """Human-readable postfix rendering of a genome."""
    stack = []
    for slot, kind in enumerate(skeleton):
        g = int(genome[slot])
        if kind == PUSH:
            stack.append(FEAT_NAMES[g])
        elif kind == UNARY:
            stack.append(f"{UNARY_NAMES[g]}({stack.pop()})")
        elif kind == BINARY:
            b = stack.pop()
            a = stack.pop()
            if BINARY_NAMES[g].startswith("rcorr"):
                stack.append(f"{BINARY_NAMES[g]}({a}, {b})")
            else:
                stack.append(f"({a} {BINARY_NAMES[g]} {b})")
        elif kind == MASK:
            stack.append(f"{stack.pop()}[{MASK_NAMES[g]}]")
        elif kind == AGG:
            stack.append(f"{AGG_NAMES[g]}({stack.pop()})")
    return f"mean({stack[0]})"
