"""The volume order statistics computed together:
``DayContext.volume_selections``, its plain version
``ops.volume_select_cuda.volume_selections_plain`` and the hand-written
kernel ``csrc/volume_select.cu`` behind it on the card.

On the CPU the seven factors it serves (the four ``mmt_*VolumeRet``
compounds, the three ``doc_vol*_ratio`` share sums) are held bit for bit
to their compositions as the factors wrote them before (the copies
below), with ``replicate_quirks`` on and off, on crafted edge rows. The
kernel's reading of one sorted row, in plain torch, is held to the plain
version over ``torch_cases.volume_rows``' ties, short, empty and
zero-volume rows, NaN, signed-zero and infinite volumes and prices: the
thresholds and the share sums bit for bit (the shares read in the volume
order where ``vol_sum > 0``), the f64 compounds at the parity
tolerances. The wrapper refuses what the kernel does not take; the
intermediate is computed once per context under one labelled span. The
``cuda`` tests hold the kernel to the plain version on the CPU at the
three step shapes and at odd slot counts from 1 to 2048, count one launch
per context and per resident step, and check the refusals on the card.

The module imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_volume_select.py -q
"""

from collections import Counter

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu_torch import kernels
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.models import (
    DayContext, compute_factors, registry)
from replication_of_minute_frequency_factor_tpu_torch.ops import (
    bottomk_threshold, masked_product, masked_sum, topk_sum, topk_threshold,
    volume_select_cuda as vs)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry, get_telemetry, set_telemetry)
from torch_cases import (
    VOLUME_ANSWERS, VOLUME_ROWS, Year, encode_year, make_batch, same_bits,
    volume_select_misses, volume_tensors)

RETS = ("mmt_top50VolumeRet", "mmt_bottom50VolumeRet", "mmt_top20VolumeRet",
        "mmt_bottom20VolumeRet")
SUMS = ("doc_vol10_ratio", "doc_vol5_ratio", "doc_vol50_ratio")
SEVEN = RETS + SUMS
_NAN = float("nan")


@pytest.fixture
def fresh_telemetry():
    prev = get_telemetry()
    tel = set_telemetry(Telemetry())
    try:
        yield tel
    finally:
        set_telemetry(prev)


def _parent(name, bars, mask, quirks):
    """The seven factors as models/momentum.py and models/chip.py wrote
    them before they were computed together."""
    vol = bars[..., 4]
    if name in SUMS:
        k = {"doc_vol10_ratio": 10, "doc_vol5_ratio": 5,
             "doc_vol50_ratio": 5 if quirks else 50}[name]
        share = vol / masked_sum(vol, mask)[..., None]
        return topk_sum(share, mask, k)
    k, largest = {"mmt_top50VolumeRet": (50, True),
                  "mmt_bottom50VolumeRet": (50, False),
                  "mmt_top20VolumeRet": (20, True),
                  "mmt_bottom20VolumeRet": (50 if quirks else 20,
                                            False)}[name]
    if largest:
        thr = topk_threshold(vol, mask, k)
        sel = mask & (vol >= thr[..., None])
    else:
        thr = bottomk_threshold(vol, mask, k)
        sel = mask & (vol <= thr[..., None])
    out = masked_product(bars[..., 3] / bars[..., 0], sel) - 1.0
    return torch.where(mask.sum(dim=-1) > 0, out, _NAN)


def _edge_batch(seed, session=None):
    """``make_batch`` with an empty row, a zero-volume row, a row of fewer
    bars than k, valid NaN / infinite / signed-zero volumes and odd
    prices."""
    bars, mask = make_batch(np.random.default_rng(seed), 2, 16,
                            session=session)
    mask[0, 1] = False
    bars[0, 2, :, 4] = 0.0
    mask[0, 3, 4:] = False
    bars[1, 4, :4, 4] = [np.nan, -np.nan, np.inf, -0.0]
    bars[1, 5, 7, 0] = 0.0
    bars[1, 6, 9, 3] = np.nan
    bars[1, 7, :, 4] = np.where(np.arange(bars.shape[2]) % 2, 0.0, -0.0)
    return torch.from_numpy(bars), torch.from_numpy(mask)


# --- the plain version is the parent's compositions ----------------------------

@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("session", [None, "us_390", "crypto_1440"])
def test_the_seven_factors_are_the_parent_compositions_bit_for_bit(
        session, quirks):
    bars, mask = _edge_batch(7, session)
    got = compute_factors(bars, mask, names=SEVEN, replicate_quirks=quirks,
                          session=session)
    for name in SEVEN:
        assert same_bits(got[name], _parent(name, bars, mask, quirks)), name
    if quirks:  # Q1 and Q3: one answer serves two factors
        assert same_bits(got["mmt_bottom20VolumeRet"],
                         got["mmt_bottom50VolumeRet"])
        assert same_bits(got["doc_vol50_ratio"], got["doc_vol5_ratio"])


@pytest.mark.parametrize("quirks,n", [(True, 5), (False, 7)])
def test_each_distinct_answer_is_computed_once(quirks, n):
    """The k of each answer is resolved on the host: with the quirks on,
    the bottom-20 is the bottom-50 and the top-50 sum the top-5."""
    bars, mask = _edge_batch(3)
    ctx = DayContext(bars, mask, replicate_quirks=quirks)
    assert len(ctx.volume_answers) == n
    assert ctx.volume_selections.shape == (n, 2, 16)
    want = vs.volume_selections_plain(bars, mask, ctx.vol_sum,
                                      ctx.volume_answers)
    assert same_bits(ctx.volume_selections, want)


# --- the kernel's reading of a sorted row, in plain torch ------------------------

_NEG_QNAN = -4194304  # 0xffc00000 as an int32


def _key(x):
    """The kernel's ``key_of``: the total-order key with each NaN folded
    onto the qNaN of its sign, plus 2^31, as int64 (never 0)."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = torch.where(torch.isnan(x), torch.where(i < 0, _NEG_QNAN,
                                                0x7fc00000), i)
    return torch.where(i < 0, i ^ 0x7fffffff, i) + 2**31


def _value(key):
    """The kernel's ``value_of``: the float a key stands for."""
    i = key - 2**31
    return torch.where(i < 0, i ^ 0x7fffffff, i).to(torch.int32).view(
        torch.float32)


def _kernel_reading(bars, mask, vol_sum, answers):
    """What the kernel answers, read as it reads them from one ascending
    sort of each row's keys with the invalid lanes at 0: a threshold from
    the valid lanes' count and the count of valid NaNs of each sign; a
    compound in f64; a share sum in the volume order where ``vol_sum >
    0``, else from a sort of the share keys."""
    vol = bars[..., 4]
    S = vol.shape[-1]
    A = torch.where(mask, _key(vol), 0).sort(dim=-1).values
    n = mask.sum(dim=-1)
    nan = mask & torch.isnan(vol)
    sign = vol.view(torch.int32) < 0
    neg, pos = (nan & sign).sum(dim=-1), (nan & ~sign).sum(dim=-1)
    invalid = S - n

    def at(keys, p):
        return torch.gather(keys, -1, p.clamp(0, S - 1)[..., None])[..., 0]

    def fold(x):
        return torch.where(torch.isnan(x), _NAN, x)

    share = fold(vol / vol_sum[..., None])
    B = torch.where(mask, _key(share), 0).sort(dim=-1).values
    by_volume = vol_sum > 0
    out = []
    for kind, k in answers:
        kk = min(k, S)
        if kind == "share_sum":
            m = torch.clamp(n, max=kk)
            s = None
            for i in range(kk):
                p = torch.full_like(n, S - 1 - i)
                term = torch.where(by_volume,
                                   fold(_value(at(A, p)) / vol_sum),
                                   _value(at(B, p)))
                term = torch.where(i < m, term, 0.0)
                s = term if s is None else s + term
            out.append(torch.where(n > 0, s, _NAN))
            continue
        j = torch.clamp(n, max=kk) - 1
        top = kind in ("top", "top_threshold")
        if top:
            tk = torch.where(j < n - neg, at(A, S - 1 - j),
                             torch.where(j < n - neg + invalid,
                                         _key(torch.tensor(-np.inf)),
                                         _key(torch.tensor(-np.nan))))
        else:
            tk = torch.where(j < n - pos, at(A, S - n + j),
                             torch.where(j < n - pos + invalid,
                                         _key(torch.tensor(np.inf)),
                                         _key(torch.tensor(np.nan))))
        thr = torch.where(n > 0, _value(tk), _NAN)
        if kind.endswith("_threshold"):
            out.append(thr)
            continue
        sel = mask & ((vol >= thr[..., None]) if top
                      else (vol <= thr[..., None]))
        ratio = (bars[..., 3] / bars[..., 0]).double()
        p = torch.where(sel, ratio, 1.0).prod(dim=-1)
        out.append(torch.where(n > 0, (p - 1.0).float(), _NAN))
    return torch.stack(out)


@pytest.mark.parametrize("answers", VOLUME_ANSWERS)
@pytest.mark.parametrize("S", [1, 2, 5, 8, 60, 240, 390, 1440])
def test_the_kernels_reading_is_the_plain_version(S, answers):
    """Bit for bit for the thresholds (any two NaNs equal: a NaN threshold
    selects nothing whatever its bits) and the share sums, the f64
    compounds at the parity tolerances, with NaN and infinite lanes
    identical, on every crafted row."""
    bars, mask, vol_sum = volume_tensors(S, S, rows=40)
    want = vs.volume_selections_plain(bars, mask, vol_sum, answers)
    got = _kernel_reading(bars, mask, vol_sum, answers)
    misses = volume_select_misses(got, want, answers)
    assert {k: misses[k] for k in ("exact", "nonfinite", "compound")} == \
        {"exact": 0, "nonfinite": 0, "compound": 0}, misses
    assert misses["compound_max_abs"] < 1e-6


def test_the_crafted_rows_reach_each_branch():
    """``volume_rows``' edge rows take the reading's branches: an invalid
    lane at the threshold, valid NaNs past it, shares read in the volume
    order and from a second sort."""
    bars, mask, vol_sum = volume_tensors(0, 240)
    r = VOLUME_ROWS
    assert not mask[r["empty"]].any() and mask[r["few"]].sum() == 3
    assert vol_sum[r["zero_volume"]] == 0 and vol_sum[r["zero_sum"]] == 0
    assert vol_sum[r["negative_sum"]] < 0
    assert torch.isnan(vol_sum[r["nan_sum"]])
    assert torch.isinf(vol_sum[r["inf_volume"]])
    got = vs.volume_selections_plain(bars, mask, vol_sum,
                                     (("top_threshold", 50),
                                      ("share_sum", 5)))
    assert got[0, r["few"]] == bars[r["few"], :3, 4].min()
    assert torch.isnan(got[1, r["zero_volume"]])
    assert torch.isinf(got[1, r["zero_sum"]])


def test_the_threshold_counts_the_invalid_lanes_past_valid_nans():
    """A row of 6 lanes: a +NaN and three -NaN volumes, 5, and an invalid
    lane. Down the top-k thresholds the invalid lane's -inf comes before
    the -NaNs, and up the bottom-k ones its +inf after 5; the kernel
    places it by counting, with no sort key of its own."""
    vol = torch.tensor([[np.nan, -np.nan, -np.nan, -np.nan, 5.0, 7.0]],
                       dtype=torch.float32)
    mask = torch.tensor([[True, True, True, True, True, False]])
    bars = torch.ones(1, 6, 5)
    bars[..., 4] = vol
    vol_sum = masked_sum(vol, mask)
    answers = tuple(("top_threshold", k) for k in range(1, 7)) + \
        (("bottom_threshold", 4), ("bottom_threshold", 5))
    want = vs.volume_selections_plain(bars, mask, vol_sum, answers)
    got = _kernel_reading(bars, mask, vol_sum, answers)
    assert volume_select_misses(got, want, answers)["exact"] == 0
    w = want[:, 0]
    assert torch.isnan(w[0]) and w[1] == 5.0 and w[2] == -np.inf
    assert torch.isnan(w[3:6]).all() and w[6] == 5.0 and w[7] == np.inf


# --- the wrapper's refusals --------------------------------------------------------

def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    """A wrong dtype, a non-contiguous tensor, mismatched shapes, rows
    longer than ``MAX_SLOTS``, answers the kernel does not know, or a
    tensor neither on the CPU nor with the others on one CUDA device raise
    before any launch, with the counter unchanged."""
    bars, mask, vol_sum = volume_tensors(1, 64, rows=12)
    a = VOLUME_ANSWERS[0]
    before = kernels.launch_count("volume_select")
    with pytest.raises(TypeError, match="float32"):
        vs.volume_selections(bars.double(), mask, vol_sum, a)
    with pytest.raises(TypeError, match="float32"):
        vs.volume_selections(bars, mask, vol_sum.double(), a)
    with pytest.raises(TypeError, match="bool"):
        vs.volume_selections(bars, mask.to(torch.uint8), vol_sum, a)
    with pytest.raises(ValueError, match="contiguous"):
        vs.volume_selections(bars.transpose(0, 1).contiguous()
                             .transpose(0, 1), mask, vol_sum, a)
    with pytest.raises(ValueError, match="expected"):
        vs.volume_selections(bars, mask[:, :32].contiguous(), vol_sum, a)
    with pytest.raises(ValueError, match="expected"):
        vs.volume_selections(bars, mask, vol_sum[:4], a)
    with pytest.raises(ValueError, match="expected"):
        vs.volume_selections(bars[..., :4].contiguous(), mask, vol_sum, a)
    wide = vs.MAX_SLOTS + 1
    with pytest.raises(ValueError, match="slots"):
        vs.volume_selections(torch.zeros(2, wide, 5),
                             torch.ones(2, wide, dtype=torch.bool),
                             torch.zeros(2), a)
    for bad in ((), a + a[:2], (("median", 5),), (("top", 0),),
                (("top", 2.0),)):
        with pytest.raises(ValueError, match="answers"):
            vs.volume_selections(bars, mask, vol_sum, bad)
    with pytest.raises(ValueError, match="CUDA device"):
        vs.volume_selections(bars.to("meta"), mask.to("meta"),
                             vol_sum.to("meta"), a)
    with pytest.raises(ValueError, match="CUDA device"):
        vs.volume_selections(bars, mask, vol_sum.to("meta"), a)
    assert kernels.launch_count("volume_select") == before


# --- one intermediate per context ----------------------------------------------------

@pytest.mark.parametrize("first", [RETS[1], SUMS[2]])
def test_the_context_computes_it_once(fresh_telemetry, first):
    """One ``ctx.volume_selections`` span whichever factor asks first,
    labelled with the rows, the slots, the impl and the answers; no
    ``ctx.ratio_co`` and no ``ctx.chip_topk_sum`` span."""
    bars, mask = make_batch(np.random.default_rng(5), 2, 16)
    bars, mask = torch.from_numpy(bars), torch.from_numpy(mask)
    tr = fresh_telemetry.tracer
    ctx = DayContext(bars, mask, tracer=tr)
    order = (first,) + tuple(n for n in SEVEN if n != first)
    got = {n: registry.resolve(n)(ctx) for n in order}
    names = Counter(e["name"] for e in tr.events())
    assert names["ctx.volume_selections"] == 1
    assert not any(n.startswith(("ctx.ratio_co", "ctx.chip_topk_sum"))
                   for n in names)
    span = next(e for e in tr.events()
                if e["name"] == "ctx.volume_selections")
    assert span["labels"] == {"rows": "32", "slots": "240", "impl": "plain",
                              "answers": "5"}
    for name in SEVEN:
        assert same_bits(got[name], _parent(name, bars, mask, True)), name


def test_a_resident_step_computes_it_once(fresh_telemetry):
    n, days, tickers = 2, 2, 16
    bufs, spec, kind = encode_year(Year(3, n, days, tickers))
    pl.compute_packed_resident([torch.from_numpy(b).clone() for b in bufs],
                               spec, kind, rolling_impl="cuda", device="cpu")
    spans = [e for e in fresh_telemetry.tracer.events()
             if e["name"] == "ctx.volume_selections"]
    assert len(spans) == n
    for e in spans:
        assert e["labels"] == {"rows": str(days * tickers), "slots": "240",
                               "impl": "plain", "answers": "5"}


# --- on the card ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _hold(bars, mask, vol_sum, label):
    """Both answer sets through the kernel against the plain version on
    the CPU, the one the tests hold to the JAX package; a second launch
    repeats the bits. (On the card the plain ``bottomk_threshold`` reads a
    valid NaN volume at the other end: it negates the volume, and the
    card's negation of a NaN does not flip its sign as the CPU's does.)
    Returns the largest compound gap."""
    worst = 0.0
    for answers in VOLUME_ANSWERS:
        before = kernels.launch_count("volume_select")
        got = vs.volume_selections(bars, mask, vol_sum, answers)
        again = vs.volume_selections(bars, mask, vol_sum, answers)
        torch.cuda.synchronize()
        assert kernels.launch_count("volume_select") == before + 2
        assert same_bits(again, got)
        misses = volume_select_misses(got, vs.volume_selections(
            bars.cpu(), mask.cpu(), vol_sum.cpu(), answers), answers)
        assert (misses["exact"], misses["nonfinite"],
                misses["compound"]) == (0, 0, 0), (label, misses)
        worst = max(worst, misses["compound_max_abs"])
    print(f"volume_select {label}: compounds within "
          f"{worst:.3e} of the plain version")
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 31, 60, 127, 240, 257, 390, 512, 513,
                               1024, 1025, 1440, 2048])
def test_kernel_matches_plain_on_the_card(S):
    """Every kind against the plain version at every row length the work
    decomposition changes around, over the crafted rows and 3000 drawn
    ones."""
    _card()
    _hold(*volume_tensors(S, S, rows=3000, device="cuda"), f"[3000, {S}]")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,S", [(160000, 240), (96000, 390),
                                    (42000, 1440)])
def test_kernel_matches_plain_at_the_step_shapes(rows, S):
    """The three cells' resident steps: the cn and us years' [32 days x
    5000 / 3000 tickers] and the venue's [28 x 1500]."""
    _card()
    _hold(*volume_tensors(rows + S, S, rows=rows, device="cuda"),
          f"[{rows}, {S}]")


@pytest.mark.cuda
def test_one_launch_per_context_on_the_card(fresh_telemetry):
    """All 58 factors of a batch launch the kernel once; the seven
    factors are held to the plain compositions on the CPU;
    a resident year of ``n`` steps launches it ``n`` times, each under one
    labelled span."""
    _card()
    bars, mask = _edge_batch(8)
    bars, mask = bars.cuda(), mask.cuda()
    before = kernels.launch_count("volume_select")
    out = compute_factors(bars, mask, rolling_impl="cuda")
    torch.cuda.synchronize()
    assert kernels.launch_count("volume_select") == before + 1
    answers = tuple((("top", 50), ("bottom", 50), ("top", 20), ("bottom", 50),
                     ("share_sum", 10), ("share_sum", 5), ("share_sum", 5)))
    want = torch.stack([_parent(n, bars.cpu(), mask.cpu(), True)
                        for n in SEVEN])
    got = torch.stack([out[n] for n in SEVEN])
    misses = volume_select_misses(got, want, answers)
    assert (misses["exact"], misses["nonfinite"], misses["compound"]) == \
        (0, 0, 0), misses
    n = 3
    bufs, spec, kind = encode_year(Year(3, n, 2, 64))
    before = kernels.launch_count("volume_select")
    pl.compute_packed_resident([torch.from_numpy(b).cuda() for b in bufs],
                               spec, kind, rolling_impl="cuda")
    torch.cuda.synchronize()
    assert kernels.launch_count("volume_select") == before + n
    spans = [e for e in fresh_telemetry.tracer.events()
             if e["name"] == "ctx.volume_selections"]
    assert Counter(e["labels"]["impl"] for e in spans) == {"cuda": n + 1}


@pytest.mark.cuda
def test_wrapper_refuses_on_the_card():
    """Mixed devices, a non-contiguous or wrong-dtype card tensor, rows
    longer than ``MAX_SLOTS``: raised before any launch; no row, no
    launch."""
    _card()
    bars, mask, vol_sum = volume_tensors(2, 240, rows=16, device="cuda")
    a = VOLUME_ANSWERS[0]
    before = kernels.launch_count("volume_select")
    with pytest.raises(ValueError, match="CUDA device"):
        vs.volume_selections(bars, mask.cpu(), vol_sum, a)
    with pytest.raises(ValueError, match="CUDA device"):
        vs.volume_selections(bars, mask, vol_sum.cpu(), a)
    with pytest.raises(ValueError, match="contiguous"):
        vs.volume_selections(bars[:, ::2], mask[:, ::2], vol_sum, a)
    with pytest.raises(TypeError, match="float32"):
        vs.volume_selections(bars.half(), mask, vol_sum, a)
    wide = vs.MAX_SLOTS + 1
    with pytest.raises(ValueError, match="slots"):
        vs.volume_selections(torch.zeros(2, wide, 5, device="cuda"),
                             torch.ones(2, wide, dtype=torch.bool,
                                        device="cuda"),
                             torch.zeros(2, device="cuda"), a)
    torch.cuda.synchronize()
    assert kernels.launch_count("volume_select") == before
    got = vs.volume_selections(bars[:0], mask[:0], vol_sum[:0], a)
    assert got.shape == (len(a), 0)
    assert kernels.launch_count("volume_select") == before
