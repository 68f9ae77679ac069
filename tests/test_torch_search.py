"""The port's symbolic search (``search.py``), held to the JAX package's.

The same seeded numpy day slabs go through JAX ``search`` (jitted, as
every JAX discovery path evaluates it) and the port's ``search`` on the
CPU. Each test states its tolerance; none is looser than the JAX
package's own test of that op against numpy (tests/test_search.py).

* Bitwise: the feature bank (the ``tod`` ramp included), the mask ops,
  the prefix sum and the rolling means built on it, the plain unary and
  binary ops, ``describe``, ``random_population`` and ``auto_chunk``.
* Within tolerance: ``log1p`` and the z-score (an ulp), the rolling std
  and corr off their degenerate edge (XLA contracts ``m2 - mu * mu``
  into an FMA, so a window with one valid bar is rounding noise under
  the square root in JAX and exactly 0 in the port; the edge lanes are
  counted and printed), the aggregates, ``eval_programs`` over both
  skeletons and ``fitness``.

Why ``eval_programs`` is held over a subset of the op tables: a z-score,
a std or a correlation of a series that is constant in exact arithmetic
(the day-constant ``gap``/``prev_ret`` features, an aggregate pushed
back as a series, a masked ``tod`` slope), or a division by such a
value, turns each framework's rounding into an answer of its own, which
the f64 evaluation shows is noise in both. Those ops are held one by one
above, off their degenerate lanes; the composed programs draw from the
ops whose conditioning is bounded, over both skeletons.

The grouped evaluation (each op on the candidates that chose it) is held
bit for bit against the all-branch select the JAX package's ``vmap``
computes, over every op of every table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from replication_of_minute_frequency_factor_tpu import search as J
from replication_of_minute_frequency_factor_tpu_torch import search as P

from torch_cases import bounded_population

#: the JAX package's interpreter tolerance (tests/test_search.py:38)
INTERP_RTOL, INTERP_ATOL = 2e-4, 1e-6
#: its rolling-op tolerance against numpy (tests/test_search.py:147)
ROLL_RTOL, ROLL_ATOL = 2e-3, 2e-3
#: its rolling-corr tolerance on far lanes (tests/test_search.py:179)
CORR_RTOL, CORR_ATOL, CORR_FAR = 0.05, 5e-3, 1e-3
#: its aggregate tolerance (tests/test_search.py:225)
AGG_RTOL, AGG_ATOL = 2e-3, 1e-5

_jit_features = jax.jit(J._features)
_jit_eval = jax.jit(J.eval_programs, static_argnums=3)


def day_batch(seed=0, D=3, T=40, S=240):
    """tests/test_search.py's day batch, plus a halted ticker, a halted
    (day, ticker) and a zero-volume bar."""
    rng = np.random.default_rng(seed)
    close = 10 * np.exp(np.cumsum(rng.normal(0, 1e-3, (D, T, S)), -1))
    open_ = close * (1 + rng.normal(0, 1e-4, close.shape))
    high = np.maximum(open_, close) * 1.0002
    low = np.minimum(open_, close) * 0.9998
    vol = rng.integers(1, 10000, close.shape).astype(np.float64)
    vol[0, 2, 5] = 0.0
    bars = np.stack([open_, high, low, close, vol], -1).astype(np.float32)
    mask = rng.random((D, T, S)) > 0.1
    mask[:, 0] = False          # halted all batch
    mask[1, 3] = False          # halted one day
    return bars, mask


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def assert_bitwise(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    assert np.array_equal(nan_g, nan_w), what
    assert np.array_equal(bits(got[~nan_g]), bits(want[~nan_w])), what


# --------------------------------------------------------------------------
# tables, features, the prefix sum
# --------------------------------------------------------------------------


def test_tables_and_constants_equal_jax():
    assert P.DEFAULT_SKELETON == J.DEFAULT_SKELETON
    assert P.RICH_SKELETON == J.RICH_SKELETON
    assert (P.PUSH, P.UNARY, P.BINARY, P.MASK, P.AGG) == \
        (J.PUSH, J.UNARY, J.BINARY, J.MASK, J.AGG)
    assert P._KIND_SIZES == J._KIND_SIZES
    assert (P.ROLL_FAST, P.ROLL_SLOW) == (J.ROLL_FAST, J.ROLL_SLOW)
    assert P._CHUNK_ELEMS == J._CHUNK_ELEMS
    for name in ("FEAT_NAMES", "UNARY_NAMES", "BINARY_NAMES",
                 "MASK_NAMES", "AGG_NAMES"):
        assert getattr(P, name) == getattr(J, name)
    assert len(P.UNARY_OPS) == J.N_UNARY
    assert len(P.BINARY_OPS) == J.N_BINARY
    assert len(P.MASK_OPS) == J.N_MASK
    assert len(P.AGG_OPS) == J.N_AGG


@pytest.mark.parametrize("n_slots", [240, 390, 1440])
def test_tod_ramp_is_the_jitted_jax_linspace_bitwise(n_slots):
    """The ``tod`` feature as JAX's jitted evaluation sees it, bit for
    bit, at the three registered slot counts."""
    bars = np.ones((1, 1, n_slots, 5), np.float32)
    mask = np.ones((1, 1, n_slots), bool)
    want = np.asarray(_jit_features(bars, mask))[8, 0, 0]
    got = P.tod_ramp(n_slots).numpy()
    assert np.array_equal(bits(got), bits(want))
    assert got[0] == -1.0 and got[-1] == 1.0


@pytest.mark.parametrize("seed,n_slots", [(0, 240), (1, 390)])
def test_feature_bank_is_bitwise_jax(seed, n_slots):
    """All 12 PUSH features, NaN lanes (day 0, halted tickers) included,
    bitwise the JAX package's jitted feature bank."""
    bars, mask = day_batch(seed, D=4, T=24, S=n_slots)
    want = np.asarray(_jit_features(bars, mask))
    got = P._features(t(bars), t(mask)).numpy()
    assert got.shape == want.shape == (12, 4, 24, n_slots)
    for i, name in enumerate(P.FEAT_NAMES):
        assert_bitwise(got[i], want[i], name)
    assert np.isnan(got[9, 0]).all() and np.isnan(got[10, 0]).all()


@pytest.mark.parametrize("n", [240, 390, 1440, 17, 16, 7])
def test_prefix_sum_is_jax_cumsum_bitwise(n):
    """The port's prefix sum is ``jnp.cumsum``'s association on the CPU,
    bit for bit, at every block layout (one block, a partial block, more
    than 16 blocks); the windowed sums built on it likewise."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((2, 3, n)) * np.exp(
        rng.standard_normal((2, 3, 1)) * 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    got = P.prefix_sum(t(x)).numpy()
    assert np.array_equal(bits(got), bits(want))
    for w in (P.ROLL_FAST, P.ROLL_SLOW):
        if w < n:
            ws = np.asarray(jax.jit(J._windowed_sum,
                                    static_argnums=1)(x, w))
            assert np.array_equal(bits(P._windowed_sum(t(x), w).numpy()),
                                  bits(ws))


def test_mask_ops_bitwise():
    """Each mask op bitwise JAX's, and both equal the numpy expectation
    (tests/test_search.py::test_mask_primitives)."""
    bars, mask = day_batch()
    ret = (bars[..., 3] - bars[..., 0]) / bars[..., 0]
    slot = np.arange(240)
    for k, want in {
        0: mask & (slot < 120),
        1: mask & (slot >= 120),
        2: mask & (slot < 30),
        3: mask & (slot >= 210),
        4: mask & (ret > 0),
        5: mask & (ret < 0),
    }.items():
        got = P.MASK_OPS[k](t(ret)[None], t(mask)).numpy()
        ref = np.asarray(jax.jit(J._apply_mask)(np.int32(k), ret, mask))
        np.testing.assert_array_equal(got[0] if got.ndim == 4 else got,
                                      want, err_msg=f"mask op {k}")
        np.testing.assert_array_equal(ref, want, err_msg=f"mask op {k}")


# --------------------------------------------------------------------------
# the op tables
# --------------------------------------------------------------------------


def _series(bars, mask):
    f = np.asarray(_jit_features(bars, mask))
    return f[5], f[3], f[4]   # ret, close, vol


@pytest.mark.parametrize("k", range(8))
def test_plain_unary_ops_match_jax(k):
    """Unary ops 0-7 on three series: bitwise, but log1p (3) within the
    interpreter tolerance and the z-score (4) within it plus the
    centring's rounding: ``x - mean`` is exact only to an ulp of the
    series, so a z-score carries 4 ulps of its row's largest |x| over
    the row's std (1e-4 absolute on ~10-CNY closes whose std is ~0.01,
    in either framework)."""
    bars, mask = day_batch(2)
    for x in _series(bars, mask):
        want = np.asarray(jax.jit(J._apply_unary)(np.int32(k), x, mask))
        got = P.UNARY_OPS[k](t(x)[None], t(mask)).numpy()[0]
        if k == 3:
            assert np.array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, rtol=INTERP_RTOL,
                                       atol=INTERP_ATOL)
        elif k == 4:
            assert np.array_equal(np.isnan(got), np.isnan(want))
            xm = np.where(mask, np.abs(x), 0).max(-1, keepdims=True)
            sd = np.nanstd(np.where(mask, x, np.nan), -1, ddof=1,
                           keepdims=True)
            with np.errstate(invalid="ignore", divide="ignore"):
                centring = 4 * np.spacing(xm.astype(np.float32)) / sd
            ok = np.isfinite(want)
            bound = (INTERP_ATOL + INTERP_RTOL * np.abs(want)
                     + np.nan_to_num(centring, posinf=0.0))
            assert np.all(np.abs(got - want)[ok] <= bound[ok])
        else:
            assert_bitwise(got, want, f"unary {k}")


@pytest.mark.parametrize("k", range(6))
def test_plain_binary_ops_are_bitwise_jax(k):
    bars, mask = day_batch(3)
    ret, close, vol = _series(bars, mask)
    for a, b in ((ret, close), (close, vol), (vol, ret)):
        want = np.asarray(jax.jit(J._apply_binary)(np.int32(k), a, b,
                                                   mask))
        got = P.BINARY_OPS[k](t(a)[None], t(b)[None], t(mask)).numpy()[0]
        assert_bitwise(got, want, f"binary {k}")


def _np_windowed(x, m, w, stat):
    """tests/test_search.py's independent trailing-window oracle, f64,
    with each window's valid count."""
    D, T, L = x.shape
    out = np.zeros((D, T, L))
    cnt = np.zeros((D, T, L), int)
    for i in range(L):
        lo = max(0, i - w + 1)
        xs = x[..., lo:i + 1]
        ms = m[..., lo:i + 1]
        n = ms.sum(-1)
        cnt[..., i] = n
        s = np.where(ms, xs, 0.0).sum(-1)
        if stat == "mean":
            out[..., i] = np.where(n > 0, s / np.maximum(n, 1), 0.0)
        else:
            mu = s / np.maximum(n, 1)
            m2 = np.where(ms, xs * xs, 0.0).sum(-1) / np.maximum(n, 1)
            out[..., i] = np.where(
                n > 0, np.sqrt(np.maximum(m2 - mu * mu, 0.0)), 0.0)
    return out, cnt


@pytest.mark.parametrize("k", [8, 9, 10, 11])
def test_rolling_unary_ops_match_jax_off_the_degenerate_edge(k, capsys):
    """Rolling means: bitwise JAX's (the prefix sum is JAX's). Rolling
    stds: NaN positions identical to JAX's and windows with no valid bar
    exactly 0 in both; every lane within the JAX package's rolling
    tolerance of the f64 oracle (its own test), and off the degenerate
    edge within it of JAX. On the edge — windows with one valid bar,
    exactly 0 in f64 — each f32 evaluation leaves its own rounding noise
    under the square root (a difference of prefix sums, and JAX's FMA in
    ``m2 - mu * mu``); those lanes are counted and printed."""
    bars, mask = day_batch(4)
    x = bars[..., 3]
    want = np.asarray(jax.jit(J._apply_unary)(np.int32(k), x, mask))
    got = P.UNARY_OPS[k](t(x)[None], t(mask)).numpy()[0]
    if k in (8, 9):
        assert_bitwise(got, want, f"rolling mean {k}")
        return
    w = P.ROLL_FAST if k == 10 else P.ROLL_SLOW
    oracle, cnt = _np_windowed(x.astype(np.float64), mask, w, "std")
    assert np.array_equal(np.isnan(got), np.isnan(want))
    empty = cnt == 0
    assert np.all(got[empty] == 0.0) and np.all(want[empty] == 0.0)
    edge = cnt == 1
    far = cnt > 1
    np.testing.assert_allclose(got[far], want[far], rtol=ROLL_RTOL,
                               atol=ROLL_ATOL)
    np.testing.assert_allclose(got, oracle, rtol=ROLL_RTOL, atol=ROLL_ATOL)
    with capsys.disabled():
        print(f"\nrolling std window {w}: {int(edge.sum())} edge lanes "
              f"(one valid bar; {int((got[edge] != want[edge]).sum())} "
              f"differ from JAX), {int(empty.sum())} empty windows, "
              f"{int(far.sum())} held")


def test_rolling_corr_matches_jax_off_the_degenerate_edge(capsys):
    """``rcorr30`` against JAX and the f64 oracle on the lanes away from
    the degenerate gate (|r| > 1e-3 in f64, the JAX package's ``far``
    lanes), with NaN positions identical to JAX's and |r| <= 1
    everywhere; the edge lanes are counted and printed."""
    bars, mask = day_batch(5)
    a, b = bars[..., 3], bars[..., 4]
    want = np.asarray(jax.jit(J._apply_binary)(np.int32(6), a, b, mask))
    got = P.BINARY_OPS[6](t(a)[None], t(b)[None], t(mask)).numpy()[0]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    w = P.ROLL_SLOW
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    D, T, L = a.shape
    oracle = np.zeros((D, T, L))
    for i in range(L):
        lo = max(0, i - w + 1)
        ms = mask[..., lo:i + 1]
        n = ms.sum(-1)
        for d in range(D):
            for tt in range(T):
                if n[d, tt] < 2:
                    continue
                av = a64[d, tt, lo:i + 1][ms[d, tt]]
                bv = b64[d, tt, lo:i + 1][ms[d, tt]]
                da, db = av - av.mean(), bv - bv.mean()
                den = np.sqrt((da * da).mean() * (db * db).mean())
                if den > 0:
                    oracle[d, tt, i] = (da * db).mean() / den
    far = np.abs(oracle) > CORR_FAR
    np.testing.assert_allclose(got[far], want[far], rtol=CORR_RTOL,
                               atol=CORR_ATOL)
    np.testing.assert_allclose(got[far], oracle[far], rtol=CORR_RTOL,
                               atol=CORR_ATOL)
    assert np.all(np.abs(got) <= 1.0)
    with capsys.disabled():
        print(f"\nrolling corr: {int((~far).sum())} edge lanes "
              f"(|r| <= {CORR_FAR} in f64), {int(far.sum())} held; "
              f"{int((got[~far] != want[~far]).sum())} edge lanes differ "
              "from JAX")


@pytest.mark.parametrize("k", range(6))
def test_agg_ops_match_jax(k):
    """Each aggregate under a value mask: the selections (last, max, min)
    bitwise, the moments within the JAX package's aggregate tolerance."""
    bars, mask = day_batch(6)
    ret = (bars[..., 3] - bars[..., 0]) / bars[..., 0]
    m = mask & (ret > 0)
    want = np.asarray(jax.jit(J._apply_agg)(np.int32(k), ret, m))
    got = P.AGG_OPS[k](t(ret)[None], t(m)).numpy()[0]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if k in (3, 4, 5):
        assert_bitwise(got, want, f"agg {k}")
    else:
        np.testing.assert_allclose(got, want, rtol=AGG_RTOL, atol=AGG_ATOL)


# --------------------------------------------------------------------------
# the interpreter
# --------------------------------------------------------------------------


def test_interpreter_matches_hand_eval_and_jax():
    """tests/test_search.py::test_interpreter_matches_hand_eval on the
    port, and the same genome against JAX."""
    bars, mask = day_batch()
    bars, mask = bars[:, 1:], mask[:, 1:]  # no halted ticker: hand eval
    skel = (P.PUSH, P.UNARY, P.PUSH, P.UNARY, P.BINARY)
    genome = np.array([[3, 4, 6, 0, 2]], np.int32)  # z(close) * vshare
    got = P.eval_programs(genome, bars, mask, skel, device="cpu").numpy()[0]
    c = bars[..., 3]
    v = bars[..., 4]
    m = mask
    mu = np.where(m, c, 0).sum(-1) / m.sum(-1)
    var = (np.where(m, (c - mu[..., None]) ** 2, 0).sum(-1)
           / (m.sum(-1) - 1))
    z = (c - mu[..., None]) / np.sqrt(var)[..., None]
    vs = v / np.maximum(np.where(m, v, 0).sum(-1, keepdims=True), 1)
    want = np.where(m, z * vs, 0).sum(-1) / m.sum(-1)
    np.testing.assert_allclose(got, want, rtol=INTERP_RTOL,
                               atol=INTERP_ATOL)
    ref = np.asarray(_jit_eval(genome, bars, mask, skel))[0]
    np.testing.assert_allclose(got, ref, rtol=INTERP_RTOL,
                               atol=INTERP_ATOL)


def test_agg_primitives_and_composition():
    """tests/test_search.py::test_agg_primitives_and_composition: the
    vol_upRatio shape std(ret|ret>0)/std(ret) on the rich skeleton."""
    bars, mask = day_batch()
    o = bars[..., 0].astype(np.float64)
    c = bars[..., 3].astype(np.float64)
    ret = (c - o) / o
    genome = np.array([[5, 0, 4, 1, 5, 0, 1, 3]], np.int32)
    got = P.eval_programs(genome, bars, mask, P.RICH_SKELETON,
                          device="cpu").numpy()[0]

    def np_std1(v):
        return np.std(v, ddof=1) if v.size >= 2 else np.nan

    D, T = mask.shape[:2]
    want = np.full((D, T), np.nan)
    for d in range(D):
        for tt in range(T):
            r = ret[d, tt][mask[d, tt]]
            up = r[r > 0]
            den = np_std1(r)
            num = np_std1(up)
            if np.isfinite(den) and den > 1e-6 and np.isfinite(num):
                want[d, tt] = num / den
    ok = np.isfinite(want)
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=AGG_RTOL,
                               atol=AGG_ATOL)
    ref = np.asarray(_jit_eval(genome, bars, mask, P.RICH_SKELETON))[0]
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=AGG_RTOL, atol=AGG_ATOL)
    s = P.describe(genome[0], P.RICH_SKELETON)
    assert s == "mean((std(id(ret)[pos]) / std(id(ret))))"


@pytest.mark.parametrize("skeleton", ["default", "rich"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_programs_matches_jax(skeleton, seed):
    """Random populations over the ops of bounded conditioning (module
    docstring), both skeletons: NaN positions identical to JAX's and
    every other lane within the interpreter tolerance."""
    skel = P.DEFAULT_SKELETON if skeleton == "default" else P.RICH_SKELETON
    bars, mask = day_batch(10 + seed, D=4, T=24)
    g = bounded_population(seed, 48, skel)
    want = np.asarray(_jit_eval(g, bars, mask, skel))
    got = P.eval_programs(g, bars, mask, skel, device="cpu").numpy()
    assert got.shape == (48, 4, 24)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=INTERP_RTOL,
                               atol=INTERP_ATOL)


def _all_branch(genomes, feats, mask, skeleton):
    """The JAX package's evaluation shape in torch: every op of a slot's
    table on the whole population, then a per-candidate select."""
    p = len(genomes)
    tail = tuple(mask.shape)

    def select(col, branches):
        out = branches[0]
        k = torch.from_numpy(col.astype(np.int64))
        for i, br in enumerate(branches):
            kk = k.view((p,) + (1,) * (br.dim() - 1))
            out = torch.where(kk == i, br, out)
        return out

    stack = []
    for slot, kind in enumerate(skeleton):
        col = genomes[:, slot]
        if kind == P.PUSH:
            stack.append((feats[torch.from_numpy(col.astype(np.int64))],
                          mask))
        elif kind == P.UNARY:
            x, m = stack.pop()
            stack.append((select(col, [op(x, m) for op in P.UNARY_OPS]),
                          m))
        elif kind == P.BINARY:
            xb, mb = stack.pop()
            xa, ma = stack.pop()
            m = ma & mb
            stack.append((select(col, [op(xa, xb, m)
                                       for op in P.BINARY_OPS]), m))
        elif kind == P.MASK:
            x, m = stack.pop()
            stack.append((x, select(col, [op(x, m).expand((p,) + tail)
                                          for op in P.MASK_OPS])))
        else:
            x, m = stack.pop()
            s = select(col, [op(x, m) for op in P.AGG_OPS])
            stack.append((s[..., None].expand((p,) + tail), mask))
    x, m = stack[0]
    return P.masked_mean(x, m)


@pytest.mark.parametrize("skeleton", ["default", "rich"])
@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_evaluation_is_bitwise_the_all_branch_select(skeleton,
                                                             seed):
    """Running each op only on the candidates that chose it gives the
    all-branch select's values bit for bit, over every op of every
    table; and each candidate's values are those of the candidate
    evaluated alone."""
    skel = P.DEFAULT_SKELETON if skeleton == "default" else P.RICH_SKELETON
    bars, mask = day_batch(20 + seed, D=3, T=16)
    g = P.random_population(np.random.default_rng(seed), 40, skel)
    tb, tm = t(bars), t(mask)
    grouped = P.eval_programs(g, tb, tm, skel).numpy()
    ref = _all_branch(g, P._features(tb, tm), tm, skel).numpy()
    assert_bitwise(grouped, ref, "grouped vs all-branch")
    for c in range(0, 40, 7):
        one = P.eval_programs(g[c:c + 1], tb, tm, skel).numpy()[0]
        assert_bitwise(one, grouped[c], f"candidate {c} alone")


# --------------------------------------------------------------------------
# fitness, chunking, the GA
# --------------------------------------------------------------------------


def test_fitness_chunked_matches_unchunked():
    """tests/test_search.py::test_fitness_chunked_matches_unchunked on
    the port — bitwise here (each candidate's values do not depend on
    its neighbours), with a short last chunk (101 % 16 != 0)."""
    bars, mask = day_batch()
    rng = np.random.default_rng(0)
    fwd = rng.normal(0, 0.02, bars.shape[:2]).astype(np.float32)
    fwd_valid = np.ones_like(fwd, bool)
    pop = P.random_population(rng, 101)
    whole = P.fitness(pop, bars, mask, fwd, fwd_valid, chunk=101,
                      device="cpu").numpy()
    chunked = P.fitness(pop, bars, mask, fwd, fwd_valid, chunk=16,
                        device="cpu").numpy()
    assert_bitwise(chunked, whole)
    auto = P.fitness(pop, bars, mask, fwd, fwd_valid, device="cpu").numpy()
    assert_bitwise(auto, whole)


def test_fitness_matches_jax():
    """``search.fitness`` (|mean per-date IC|) against JAX's on a bounded
    population: NaN positions identical, values within the interpreter
    tolerance."""
    bars, mask = day_batch(7, D=4, T=32)
    rng = np.random.default_rng(1)
    fwd = rng.normal(0, 0.02, bars.shape[:2]).astype(np.float32)
    fwd_valid = rng.random(fwd.shape) > 0.1
    g = bounded_population(3, 40, P.DEFAULT_SKELETON)
    want = np.asarray(J.fitness(g, bars, mask, fwd, fwd_valid, chunk=16))
    got = P.fitness(g, bars, mask, fwd, fwd_valid, chunk=16,
                    device="cpu").numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=INTERP_RTOL,
                               atol=INTERP_ATOL)


def test_auto_chunk_random_population_and_describe_equal_jax():
    for shape in ((1, 1000, 240), (3, 40, 240), (244, 5000, 240),
                  (16, 512, 240), (8, 5000, 390)):
        assert P.auto_chunk(shape) == J.auto_chunk(shape)
    assert P.auto_chunk((16, 512, 240)) == 17  # the card's discovery slab
    for skel in (P.DEFAULT_SKELETON, P.RICH_SKELETON, (0, 3, 4)):
        gp = P.random_population(np.random.default_rng(9), 64, skel)
        gj = J.random_population(np.random.default_rng(9), 64, skel)
        assert gp.dtype == gj.dtype == np.int32
        np.testing.assert_array_equal(gp, gj)
        for g in gp:
            assert P.describe(g, skel) == J.describe(g, skel)


def test_genomes_are_host_data():
    bars, mask = day_batch()
    g = P.random_population(np.random.default_rng(0), 4)
    a = P.eval_programs(g, bars, mask, device="cpu").numpy()
    b = P.eval_programs(torch.from_numpy(g), bars, mask,
                        device="cpu").numpy()
    assert_bitwise(a, b)
    with pytest.raises(ValueError, match=r"\[P, L\]"):
        P.eval_programs(g[0], bars, mask, device="cpu")


def _planted(bars, mask, rng):
    o = bars[..., 0]
    c = bars[..., 3]
    ret = np.where(mask, (c - o) / o, 0.0)
    signal = ret.sum(-1) / np.maximum(mask.sum(-1), 1)
    fwd = signal + rng.normal(0, signal.std() * 0.3, signal.shape)
    return fwd.astype(np.float32), np.ones_like(fwd, bool)


def test_evolve_recovers_planted_signal():
    """tests/test_search.py::test_evolve_recovers_planted_signal on the
    port: a forward return planted on the mean intrabar return is found
    (fitness > 0.5), and the history improves."""
    bars, mask = day_batch()
    bars, mask = bars[:, 1:], mask[:, 1:]
    fwd, fwd_valid = _planted(bars, mask, np.random.default_rng(0))
    res = P.evolve(bars, mask, fwd, fwd_valid, pop=256, generations=6,
                   seed=1, device_batch=256, device="cpu")
    assert res.fitness > 0.5, P.describe(res.genome)
    assert res.history[-1] >= res.history[0]


def test_time_mask_factor_recovery():
    """tests/test_search.py::test_time_mask_factor_recovery on the port:
    a last-30-minute volume share is recovered through the MASK
    primitive on a 3-slot skeleton."""
    bars, mask = day_batch()
    bars, mask = bars[:, 1:], mask[:, 1:]
    v = bars[..., 4].astype(np.float64)
    tail = mask & (np.arange(240) >= 210)
    signal = (np.where(tail, v, 0.0).sum(-1)
              / np.maximum(np.where(mask, v, 0.0).sum(-1), 1.0))
    fwd = (signal - signal.mean(-1, keepdims=True)).astype(np.float32)
    skel = (P.PUSH, P.MASK, P.AGG)
    res = P.evolve(bars, mask, fwd, np.isfinite(signal), pop=128,
                   generations=6, seed=5, skeleton=skel, device_batch=128,
                   device="cpu")
    assert res.fitness > 0.95, P.describe(res.genome, skel)
    desc = P.describe(res.genome, skel)
    assert any(s in desc for s in ("last30", "first30", "am", "pm")), desc
