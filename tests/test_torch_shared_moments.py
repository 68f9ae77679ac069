"""The moments and stds that several factors share, computed once a
context: ``DayContext.moments`` (the count, mean and central sums of
orders 2-4 of ``ret_co`` and of ``vol_share``, one pass each, read by the
six shape factors and the std of ``ret_co``), the volatility family's
memoised std of ``ret_co`` and its two signed volatilities (read by
``vol_return1min``, ``vol_upVol``, ``vol_downVol`` and the up/down
ratios), and ``beta_moments``' one pass over the window betas.

The op sequence is the one the factors ran when each recomputed what it
needed, so every factor is held bit for bit to those compositions: the
copies below of ``ops/masked.py``'s ``masked_mean``, ``masked_var``,
``masked_std``, ``masked_skew`` and ``masked_kurtosis``, of
``DayContext.beta_moments`` and of the eleven touched factor bodies as
they were written before. The edge rows have one bar, two bars, zero
variance, a zero-volume day, NaN and infinite lanes, masked lanes and
absent tickers, at 240, 390 and 1,440 slots. In one context over all 58
factors each shared intermediate is one ``ctx.<key>`` span. The ``cuda``
tests hold all 58 factors to the same compositions on the card, on
decoded batches and on the edge rows.

The module imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_shared_moments.py -q
"""

import sys
from collections import Counter

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu_torch.data import wire
from replication_of_minute_frequency_factor_tpu_torch.models import (
    DayContext, compute_factors, registry)
from replication_of_minute_frequency_factor_tpu_torch.ops import (
    masked, masked_last)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry, get_telemetry, set_telemetry)
from torch_cases import make_batch, same_bits

PKG = "replication_of_minute_frequency_factor_tpu_torch"
SESSIONS = (None, "us_390", "crypto_1440")
_NAN = float("nan")


@pytest.fixture
def fresh_telemetry():
    prev = get_telemetry()
    tel = set_telemetry(Telemetry())
    try:
        yield tel
    finally:
        set_telemetry(prev)


# --- the parent's compositions ---------------------------------------------------

def _count(mask):
    return mask.sum(dim=-1)


def _masked_mean(x, mask):
    n = _count(mask)
    s = torch.where(mask, x, 0.0).sum(dim=-1)
    return torch.where(n > 0, s / n.clamp(min=1), _NAN)


def _central_moment(x, mask, mu, k):
    d = torch.where(mask, x - mu[..., None], 0.0)
    if k == 4:
        d2 = d * d
        return (d2 * d2).sum(dim=-1)
    return (d**k).sum(dim=-1)


def _masked_var(x, mask, ddof=1):
    n = _count(mask)
    mu = _masked_mean(x, mask)
    m2 = _central_moment(x, mask, mu, 2)
    denom = (n - ddof).clamp(min=1)
    return torch.where(n > ddof, m2 / denom, _NAN)


def _masked_std(x, mask, ddof=1):
    return torch.sqrt(_masked_var(x, mask, ddof=ddof))


def _masked_skew(x, mask):
    n = _count(mask)
    mu = _masked_mean(x, mask)
    nn = n.clamp(min=1)
    m2 = _central_moment(x, mask, mu, 2) / nn
    m3 = _central_moment(x, mask, mu, 3) / nn
    g1 = m3 / (m2 * torch.sqrt(m2))
    return torch.where(n > 0, g1, _NAN)


def _masked_kurtosis(x, mask):
    n = _count(mask)
    mu = _masked_mean(x, mask)
    nn = n.clamp(min=1)
    m2 = _central_moment(x, mask, mu, 2) / nn
    m4 = _central_moment(x, mask, mu, 4) / nn
    g2 = m4 / (m2 * m2) - 3.0
    return torch.where(n > 0, g2, _NAN)


PARENT_OPS = {"masked_mean": _masked_mean, "masked_var": _masked_var,
              "masked_std": _masked_std, "masked_skew": _masked_skew,
              "masked_kurtosis": _masked_kurtosis}


def _signed_vol(ctx, positive):
    ret = ctx.ret_co
    sel = ctx.mask & ((ret > 0) if positive else (ret < 0))
    n_sel = sel.sum(dim=-1)
    s = _masked_std(ret, sel)
    out = torch.where(n_sel < 2, 0.0, s)
    return torch.where(ctx.has_bars, out, _NAN)


def _beta_moments(self):
    """``DayContext.beta_moments`` as it was written before it read one
    moment pass."""
    def f():
        st = self.rolling50
        valid, beta = st["valid"], self.rolling_beta
        n = valid.sum(dim=-1)
        mean = _masked_mean(beta, valid)
        std = _masked_std(beta, valid)
        last = masked_last(beta, valid)
        scale = torch.maximum(mean.abs(), last.abs())
        eps = torch.finfo(torch.float32).eps
        std = torch.where(std <= 16 * eps * scale, 0.0, std)
        return mean, std, last, n
    return self._get("beta_moments", f)


#: the eleven factor bodies as they were written before the memos
PARENT_FACTORS = {
    "shape_skew": lambda c: _masked_skew(c.ret_co, c.mask),
    "shape_kurt": lambda c: _masked_kurtosis(c.ret_co, c.mask),
    "shape_skratio": lambda c: (_masked_skew(c.ret_co, c.mask)
                                / _masked_kurtosis(c.ret_co, c.mask)),
    "shape_skewVol": lambda c: _masked_skew(c.vol_share, c.mask),
    "shape_kurtVol": lambda c: _masked_kurtosis(c.vol_share, c.mask),
    "shape_skratioVol": lambda c: (_masked_skew(c.vol_share, c.mask)
                                   / _masked_kurtosis(c.vol_share, c.mask)),
    "vol_return1min": lambda c: _masked_std(c.ret_co, c.mask),
    "vol_upVol": lambda c: _signed_vol(c, True),
    "vol_upRatio": lambda c: (_signed_vol(c, True)
                              / _masked_std(c.ret_co, c.mask)),
    "vol_downVol": lambda c: _signed_vol(c, False),
    "vol_downRatio": lambda c: (_signed_vol(c, False)
                                / _masked_std(c.ret_co, c.mask)),
}
TOUCHED = tuple(PARENT_FACTORS)

#: the intermediates the memos add, one span a context each
SHARED_SPANS = ("ctx.moments.ret_co", "ctx.moments.vol_share",
                "ctx.ret_co_std", "ctx.signed_vol.up", "ctx.signed_vol.down")


def parent_factors(bars, mask, session=None, **kw):
    """All 58 factors as the parent computed them: the eleven bodies and
    ``beta_moments`` above, and every module of the port that holds one
    of the masked ops given the parent's copy of it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DayContext, "beta_moments", _beta_moments)
        for mod in [m for n, m in sys.modules.items()
                    if n.startswith(PKG) and m is not None]:
            for name, fn in PARENT_OPS.items():
                if getattr(mod, name, None) is getattr(masked, name):
                    mp.setattr(mod, name, fn)
        for name, body in PARENT_FACTORS.items():
            mp.setitem(registry.FACTORS, name, body)
        return compute_factors(bars, mask, session=session, **kw)


def edge_batch(seed, session=None):
    """``make_batch`` (2 days x 16 tickers) with crafted rows: one bar,
    two bars, zero variance of both series, a zero-volume day, valid NaN
    and infinite prices and volumes, masked NaN lanes, a masked third of
    a row, and two absent tickers."""
    bars, mask = make_batch(np.random.default_rng(seed), 2, 16,
                            session=session)
    mask[0, 1] = False
    mask[0, 1, 5] = True                        # one bar
    mask[0, 2] = False
    mask[0, 2, [3, 4]] = True                   # two bars
    bars[0, 3, :, 0] = bars[0, 3, :, 3] = 10.0  # ret_co all 0
    bars[0, 3, :, 4] = 300.0                    # vol_share constant
    bars[0, 4, :, 4] = 0.0                      # zero-volume day
    bars[1, 4, 3, 3] = np.nan                   # valid NaN close
    bars[1, 4, 5, 4] = np.nan                   # valid NaN volume
    bars[1, 5, 6, 3] = np.inf                   # ret_co +inf
    bars[1, 5, 7, 0] = 0.0                      # open 0: ret_co inf / NaN
    bars[1, 6, 2, 4] = np.inf                   # volume +inf
    bars[1, 6, 8, 3] = -np.inf                  # ret_co -inf
    bars[1, 7, 0, 3] = np.nan                   # masked NaN close
    bars[1, 7, 1, 4] = np.inf                   # masked inf volume
    mask[1, 7, ::3] = False                     # masked lanes
    mask[1, 8] = False                          # absent
    mask[0, 15] = False                         # absent
    return torch.from_numpy(bars), torch.from_numpy(mask)


# --- on the CPU ------------------------------------------------------------------

@pytest.mark.parametrize("session", SESSIONS)
@pytest.mark.parametrize("op", list(PARENT_OPS))
def test_the_masked_ops_keep_their_bits(op, session):
    """``ops.masked``'s moments, now sharing one pass, are the parent's
    compositions bit for bit on every series of the edge rows."""
    bars, mask = edge_batch(11, session)
    ctx = DayContext(bars, mask, session=session)
    for x in (ctx.ret_co, ctx.vol_share, ctx.volume, ctx.range_hl):
        for m in (mask, mask & (ctx.ret_co > 0)):
            assert same_bits(getattr(masked, op)(x, m),
                             PARENT_OPS[op](x, m)), op


@pytest.mark.parametrize("session", SESSIONS)
@pytest.mark.parametrize("name", TOUCHED)
def test_the_touched_factors_are_the_parent_compositions_bit_for_bit(
        name, session):
    bars, mask = edge_batch(7, session)
    got = compute_factors(bars, mask, names=(name,), session=session)
    want = PARENT_FACTORS[name](DayContext(bars, mask, session=session))
    assert same_bits(got[name], want), name


@pytest.mark.parametrize("session", SESSIONS)
def test_all_58_factors_are_the_parents_bit_for_bit(session):
    bars, mask = edge_batch(13, session)
    got = compute_factors(bars, mask, session=session)
    want = parent_factors(bars, mask, session=session)
    assert len(got) == 58
    assert [n for n in got if not same_bits(got[n], want[n])] == []


def test_the_moments_count_by_n_bars():
    """The memo's count is the context's ``n_bars`` itself, its mean is
    ``masked_mean``'s, and its sums are ``masked_moments``' over the
    mask; the parent's m2 is its second sum."""
    bars, mask = edge_batch(17)
    ctx = DayContext(bars, mask)
    for series in ("ret_co", "vol_share"):
        x = getattr(ctx, series)
        n, mu, s = ctx.moments(series)
        assert n is ctx.n_bars and sorted(s) == [2, 3, 4]
        w_n, w_mu, w_s = masked.masked_moments(x, mask)
        assert same_bits(n, w_n) and same_bits(mu, w_mu)
        assert all(same_bits(s[k], w_s[k]) for k in (2, 3, 4))
        assert same_bits(mu, _masked_mean(x, mask))
        assert same_bits(s[2], _central_moment(x, mask, mu, 2))
        assert same_bits(s[3], _central_moment(x, mask, mu, 3))
        assert same_bits(s[4], _central_moment(x, mask, mu, 4))


@pytest.mark.parametrize("order", ["registry", "reversed"])
def test_each_shared_intermediate_is_computed_once(fresh_telemetry, order):
    """One context over all 58 factors, in either order: each memo is one
    ``ctx.<key>`` span, under the span of the factor or the intermediate
    that asked first; the factors are the parent's bits."""
    bars, mask = edge_batch(19)
    names = registry.factor_names()
    if order == "reversed":
        names = names[::-1]
    tr = fresh_telemetry.tracer
    got = compute_factors(bars, mask, names=names, tracer=tr)
    ev = tr.events()
    count = Counter(e["name"] for e in ev)
    assert {s: count[s] for s in SHARED_SPANS} == dict.fromkeys(
        SHARED_SPANS, 1)
    ids = {e["id"]: e["name"] for e in ev}
    for e in ev:
        if e["name"] in SHARED_SPANS:
            assert ids[e["parent"]].startswith(("factor.", "ctx."))
    want = parent_factors(bars, mask)
    assert [n for n in names if not same_bits(got[n], want[n])] == []


def test_a_lone_ratio_factor_makes_one_moment_pass(fresh_telemetry):
    """``shape_skratio`` alone reads its skew and its kurtosis from one
    ``ctx.moments.ret_co``; ``vol_upRatio`` alone one std of each kind."""
    bars, mask = edge_batch(23)
    tr = fresh_telemetry.tracer
    compute_factors(bars, mask, names=("shape_skratio", "vol_upRatio"),
                    tracer=tr)
    count = Counter(e["name"] for e in tr.events())
    assert count["ctx.moments.ret_co"] == 1
    assert count["ctx.ret_co_std"] == count["ctx.signed_vol.up"] == 1
    assert "ctx.moments.vol_share" not in count


# --- on the card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the factors' kernels have no "
                    "CPU mode")


def _decoded(session, seed):
    """A ``make_batch`` batch (4 days x 256 tickers) wire-encoded on the
    host and decoded on the card."""
    bars, mask = make_batch(np.random.default_rng(seed), 4, 256,
                            session=session)
    buf, spec = wire.pack_arrays(wire.encode(bars, mask).arrays)
    return wire.decode(*wire.unpack(torch.from_numpy(buf).cuda(), spec))


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["decoded", "edge"])
@pytest.mark.parametrize("session", SESSIONS)
def test_all_58_factors_on_the_card_are_the_parents_bit_for_bit(
        session, source):
    _card()
    if source == "decoded":
        bars, mask = _decoded(session, 29)
    else:
        bars, mask = (t.cuda() for t in edge_batch(31, session))
    got = compute_factors(bars, mask, session=session, rolling_impl="cuda")
    want = parent_factors(bars, mask, session=session, rolling_impl="cuda")
    torch.cuda.synchronize()
    assert len(got) == 58 and all(v.is_cuda for v in got.values())
    assert [n for n in got if not same_bits(got[n], want[n])] == []
