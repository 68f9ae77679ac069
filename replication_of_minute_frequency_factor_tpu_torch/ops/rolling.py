"""Rolling-window regression statistics over the minute grid.

The ``mmt_ols_*`` family (reference
MinuteFrequentFactorCalculateMethodsCICC.py:93-376) runs polars
``.rolling(index_column='minute_in_trade', period='50i')``: the window at
trade-minute m covers slots [m-49, m] on the dense grid, and windows with
fewer than 50 present bars are dropped. Because the interval spans exactly
50 integer slots, a window is kept iff every slot in it holds a bar, so the
dense formulation is exact: compute stats at every slot and mark a window
valid when its masked count equals ``window``.

The port of the JAX package's ``ops/rolling.py``. Numerical note, as
there: cov/var are shift-invariant, so second moments run on
*day-mean-centred* prices, and windowed sums are independent W-term sums
per window (never a difference of cumulative sums, which costs ~3 digits
at f32). Here a window sum is a zero-padded ``unfold`` summed over the
window axis: full f32 whatever ``torch.backends.cudnn.allow_tf32`` says,
where a ones-kernel ``conv1d`` on the card would run in TF32 by default
and break the exact count ``n_w > window - 0.5``. Second moments
accumulate squared deviations over the window offsets directly —
Σ_j (x[m-j] - μ_w[m])² — so no near-equal subtraction ever happens.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import pins
from .masked import masked_mean

#: rolling backends: 'cuda' (the hand-written Hopper kernel for the
#: second-moment pass, ops/rolling_cuda.py; the plain torch version for
#: tensors on the CPU), 'torch' (the plain torch version everywhere)
ROLLING_IMPLS = ("cuda", "torch")

#: ``(requested, resolved) -> calls``: which backend actually computed
#: the second moments (the JAX package counts the same pair as its
#: ``rolling.impl`` telemetry counter)
IMPL_COUNTS: Dict[Tuple[str, str], int] = {}


def _windowed_sum(a, window: int):
    """Inclusive trailing-window sums: out[..., m] = sum(a[..., m-W+1 : m+1])."""
    if not a.is_floating_point():
        a = a.to(torch.float32)
    return F.pad(a, (window - 1, 0)).unfold(-1, window, 1).sum(dim=-1)


#: window offsets materialized per gather in the plain second-moment
#: pass: bounds the live patch tensor to ``[..., L, MOMENT_CHUNK]``
#: (the JAX package's value)
MOMENT_CHUNK = 25


def _window_chunk(a, lo: int, hi: int):
    """Trailing-window offsets ``[lo, hi)`` materialized as one strided
    gather: ``out[..., m, k] = a[..., m - (lo + k)]``, zero-filled where
    the index runs off the left edge (those lanes only reach windows
    whose masked count is already short — invalid slots by construction).
    """
    L = a.shape[-1]
    ap = F.pad(a, (hi - 1, 0))
    ar = torch.arange(L, device=a.device)[:, None]
    offs = torch.arange(lo, hi, device=a.device)[None, :]
    return ap[..., hi - 1 + ar - offs]


def _second_moments_conv(xc, yc, mu_x, mu_y, window: int,
                         chunk: int = MOMENT_CHUNK):
    """Σ_j d_j², Σ_j e_j², Σ_j d_j·e_j with d_j = x[m-j] - μ_w[m]: the
    trailing windows are materialized by strided gather (``chunk``
    offsets at a time) and each chunk collapses through three window
    dot products. The plain version of the Hopper kernel
    (ops/rolling_cuda.py), and the backend for ``rolling_impl='torch'``.

    Windows touching the zero-filled left edge produce garbage — only at
    slots whose window is incomplete, i.e. already invalid.
    """
    s_xx = s_yy = s_xy = None
    for c0 in range(0, window, chunk):
        c1 = min(c0 + chunk, window)
        wx = _window_chunk(xc, c0, c1) - mu_x[..., None]
        wy = _window_chunk(yc, c0, c1) - mu_y[..., None]
        t_xx = (wx * wx).sum(dim=-1)
        t_yy = (wy * wy).sum(dim=-1)
        t_xy = (wx * wy).sum(dim=-1)
        if s_xx is None:
            s_xx, s_yy, s_xy = t_xx, t_yy, t_xy
        else:
            s_xx, s_yy, s_xy = s_xx + t_xx, s_yy + t_yy, s_xy + t_xy
    return s_xx, s_yy, s_xy


def second_moment_inputs(x, y, mask, window: int):
    """The second-moment pass's inputs ``(xc, yc, mu_x, mu_y)``: the
    series centred on their day means (masked lanes 0) and their
    trailing-window means.

    Day-mean centring is the production side of the constant_window pin:
    a constant window centres to one value with few significant bits,
    whose windowed mean is that value exactly, so its deviations are
    exact zeros -> exactly-zero var/cov (the "degenerate" reading) on
    every device and in any summation order. Under "noise" the centring
    is skipped and raw f32 accumulation decides."""
    if pins.reading("constant_window") == "degenerate":
        xc = torch.where(mask, x - masked_mean(x, mask)[..., None], 0.0)
        yc = torch.where(mask, y - masked_mean(y, mask)[..., None], 0.0)
    else:
        xc = torch.where(mask, x, 0.0)
        yc = torch.where(mask, y, 0.0)
    inv_w = 1.0 / window
    mu_x = _windowed_sum(xc, window) * inv_w
    mu_y = _windowed_sum(yc, window) * inv_w
    return xc, yc, mu_x, mu_y


def rolling_window_stats(x, y, mask, window: int = 50,
                         impl: str = None) -> Dict[str, torch.Tensor]:
    """Per-slot trailing-window moments of (x, y) over valid bars.

    Returns dict of ``[..., L]`` tensors:
      ``valid``   — window complete (all ``window`` slots hold bars)
      ``mean_x``/``mean_y`` — raw windowed means
      ``cov``     — windowed covariance, ddof=0
      ``var_x``/``var_y`` — windowed variances, ddof=0

    Stats are only meaningful where ``valid``; other lanes are garbage and
    must be masked by the caller.

    ``impl`` (see :data:`ROLLING_IMPLS`; None reads
    ``Config.rolling_impl``) picks the second-moment backend only:
    counts, means and validity always come from the shared torch path.
    The (requested, resolved) pair is counted in :data:`IMPL_COUNTS`.
    """
    if impl is None:
        from ..config import get_config
        impl = get_config().rolling_impl
    if impl not in ROLLING_IMPLS:
        raise ValueError(f"unknown rolling_impl {impl!r}; "
                         f"expected one of {ROLLING_IMPLS}")
    resolved = "cuda" if impl == "cuda" and x.device.type != "cpu" else "torch"
    IMPL_COUNTS[(impl, resolved)] = IMPL_COUNTS.get((impl, resolved), 0) + 1

    n_w = _windowed_sum(mask, window)
    valid = n_w > window - 0.5  # robust count equality for float window sums
    mean_x = _windowed_sum(torch.where(mask, x, 0.0), window) / window
    mean_y = _windowed_sum(torch.where(mask, y, 0.0), window) / window

    # A valid window has all `window` bars present, so edge-padded lanes
    # can only pollute windows already marked invalid and need no masking.
    xc, yc, mu_x, mu_y = second_moment_inputs(x, y, mask, window)
    if resolved == "cuda":
        from . import rolling_cuda
        s_xx, s_yy, s_xy = rolling_cuda.second_moments(
            xc, yc, mu_x, mu_y, window)
    else:
        s_xx, s_yy, s_xy = _second_moments_conv(xc, yc, mu_x, mu_y, window)
    inv_w = 1.0 / window
    return {
        "valid": valid,
        "mean_x": mean_x,
        "mean_y": mean_y,
        "cov": s_xy * inv_w,
        "var_x": (s_xx * inv_w).clamp(min=0.0),
        "var_y": (s_yy * inv_w).clamp(min=0.0),
    }


# --------------------------------------------------------------------------
# parity smoke (the tests and chip_smoke.py run it)
# --------------------------------------------------------------------------


def _f64_reference(x, y, mask, window):
    """Naive f64 windowed moments (numpy, per-window two-pass) — the
    oracle the smoke compares against."""
    import numpy as np

    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mask = np.asarray(mask, bool)
    out = {k: np.full(x.shape, np.nan)
           for k in ("mean_x", "mean_y", "cov", "var_x", "var_y")}
    valid = np.zeros(x.shape, bool)
    L = x.shape[-1]
    for i in np.ndindex(x.shape[:-1]):
        for m_ in range(window - 1, L):
            sel = mask[i][m_ - window + 1:m_ + 1]
            if not sel.all():
                continue
            xs = x[i][m_ - window + 1:m_ + 1]
            ys = y[i][m_ - window + 1:m_ + 1]
            valid[i][m_] = True
            out["mean_x"][i][m_] = xs.mean()
            out["mean_y"][i][m_] = ys.mean()
            out["cov"][i][m_] = ((xs - xs.mean()) * (ys - ys.mean())).mean()
            out["var_x"][i][m_] = xs.var()
            out["var_y"][i][m_] = ys.var()
    out["valid"] = valid
    return out


def _smoke_case(seed, length=240):
    """The JAX package's ``_smoke`` input recipe at ``length`` slots: a
    close random walk, low/high at -/+0.1%, 5% missing bars, one
    full-coverage row and one constant row (the degenerate pin's case).
    Returns f32 ``(low, high)`` and the bool mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (3, length)
    close = 10.0 * np.exp(np.cumsum(
        rng.standard_normal(shape) * 1e-3, axis=-1))
    low = close * 0.999
    high = close * 1.001
    mask = rng.random(shape) > 0.05
    mask[0] = True
    low[2] = low[2, 0:1]
    high[2] = high[2, 0:1]
    return low.astype(np.float32), high.astype(np.float32), mask


def _smoke(seeds=(0, 739), window=50, rtol=5e-4, atol=1e-6, length=240,
           device="cuda"):
    """Parity check of every backend against the f64 reference on the
    :func:`_smoke_case` inputs; on a card the kernel must also agree
    with the plain version far tighter than either agrees with f64.
    Returns a result dict; raises AssertionError on a parity failure."""
    import numpy as np

    impls = ("torch",) if torch.device(device).type == "cpu" else ROLLING_IMPLS
    checks = 0
    for seed in seeds:
        low, high, mask = _smoke_case(seed, length)
        ref = _f64_reference(low, high, mask, window)
        outs = {}
        for impl in impls:
            st = {k: v.cpu().numpy() for k, v in rolling_window_stats(
                torch.from_numpy(low).to(device),
                torch.from_numpy(high).to(device),
                torch.from_numpy(mask).to(device), window, impl=impl).items()}
            np.testing.assert_array_equal(st["valid"], ref["valid"])
            v = st["valid"]
            for k in ("mean_x", "mean_y", "cov", "var_x", "var_y"):
                np.testing.assert_allclose(st[k][v], ref[k][v],
                                           rtol=rtol, atol=atol)
            # degenerate pin: constant full-coverage windows carry
            # exactly-zero variance (pins.constant_window default)
            assert float(np.max(np.where(v[2], st["var_x"][2], 0.0))) == 0.0
            outs[impl] = st
            checks += 1
        if len(outs) > 1:
            v = outs["torch"]["valid"]
            for k in ("cov", "var_x", "var_y"):
                np.testing.assert_allclose(outs["cuda"][k][v],
                                           outs["torch"][k][v],
                                           rtol=1e-5, atol=1e-9)
    return {"ok": True, "checks": checks, "seeds": list(seeds),
            "window": window, "length": length, "impls": list(impls)}

