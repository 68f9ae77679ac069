"""Rolling second-moment fuzz: the hand-written CUDA kernels of
``csrc/rolling_moments.cu`` against their plain version over random
shapes, windows, masks and magnitudes (the place of the JAX package's
retired Pallas-kernel fuzz).

On the card, each case (:func:`.scenarios.rolling_case`) runs:

* the tiled kernel (window 50, through ``rolling_cuda.second_moments``)
  and the rowwise kernel (any window); at window 50 the two must agree
  bit for bit on every lane;
* each kernel against ``rolling_cuda.second_moments_plain`` on the same
  inputs: on every complete window the parity suite's rolling tolerance
  (``_assert_rolling_close``: rtol 2e-3, atol 1e-6 on cov, var_x and
  var_y), the covariance's widened by the f32 rounding bound of two
  orderings of one window sum (:func:`rounding_allowance`); s_xx and
  s_yy exactly zero on the same lanes;
* past a kernel's shared-memory span (the tiled kernel's L > 7264, the
  rowwise kernel's L + window - 1 > 7264) and on a misaligned view the
  call must raise, leave its inputs untouched, and leave the next launch
  working.

On the CPU the plain version's window statistics
(``rolling_window_stats(impl='torch')``) are held against a per-window
f64 oracle on the first :data:`CPU_ROWS` rows of each case, at the same
tolerance, widened by the f32 rounding of the centring and the window
mean as well.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scenarios

#: the parity suite's rolling closeness (tests/test_parity.py
#: ROLLING_RTOL / ROLLING_ATOL)
ROLLING_RTOL = 2e-3
ROLLING_ATOL = 1e-6
#: rows of a case the CPU path compares with the f64 oracle
CPU_ROWS = 32
#: the kernels' shared-memory span: the tiled kernel's largest row, the
#: rowwise kernel's largest L + window - 1 (two stages of 4 rows)
SPAN_MAX = scenarios.TILED_MAX_L
_EPS32 = float(np.finfo(np.float32).eps)
_STATS = ("cov", "var_x", "var_y")


def rounding_allowance(ref, window: int, X=None, Y=None):
    """Per-lane f32 rounding allowance ``{stat: array}`` over ``ref``'s
    window statistics. Two evaluations of the same W products in other
    orders differ by at most ``2 W u sum|d e|`` (u = 2**-24), and
    ``sum|d e| <= W sqrt(var_x var_y)``: the covariance's allowance; a
    variance's is inside the rtol (all its terms are >= 0). Against exact
    arithmetic (``X``, ``Y``: each row's largest centred magnitude) the
    f32 centring and window mean add ``E = (W + 2) u X`` to each
    deviation: ``2 E sqrt(var) + E**2`` more."""
    u = _EPS32 / 2
    w = float(window)
    sx = np.sqrt(np.nan_to_num(np.maximum(ref["var_x"], 0.0)))
    sy = np.sqrt(np.nan_to_num(np.maximum(ref["var_y"], 0.0)))
    out = {"cov": 2 * w * u * sx * sy, "var_x": 0.0, "var_y": 0.0}
    if X is not None:
        ex, ey = (w + 2) * u * X, (w + 2) * u * Y
        out["cov"] = out["cov"] + ex * sy + ey * sx + ex * ey
        out["var_x"] = 2 * ex * sx + ex * ex
        out["var_y"] = 2 * ey * sy + ey * ey
    return out


def _row_max(a, mask):
    """Each row's largest |a| over its valid lanes, ``[rows, 1]`` f64."""
    a = np.abs(np.asarray(a, np.float64))
    return np.where(np.asarray(mask, bool), a, 0.0).max(
        axis=-1, keepdims=True)


def _close(label, got, ref, valid, allow):
    """Fails with a message unless every valid lane of each statistic is
    within tolerance of ``ref``."""
    for k in _STATS:
        a = np.asarray(got[k], np.float64)
        b = np.asarray(ref[k], np.float64)
        tol = ROLLING_ATOL + ROLLING_RTOL * np.abs(b) + allow[k]
        bad = valid & ~(np.abs(a - b) <= tol)
        if bad.any():
            i = np.argwhere(bad)[0]
            raise AssertionError(
                f"{label}: {k} out of tolerance at {int(bad.sum())} of "
                f"{int(valid.sum())} valid lanes (first {tuple(i)}: "
                f"{a[tuple(i)]!r} vs {b[tuple(i)]!r})")


def _stats(moments, window):
    s_xx, s_yy, s_xy = (t.double().cpu().numpy() for t in moments)
    return {"cov": s_xy / window, "var_x": np.maximum(s_xx / window, 0.0),
            "var_y": np.maximum(s_yy / window, 0.0),
            "s_xx": s_xx, "s_yy": s_yy}


def f64_window_stats(x, y, mask, window: int, chunk_elems: int = 1 << 22):
    """Per-window f64 means, covariance and variances (ddof 0) over
    complete windows, vectorised over row chunks; the parity suite's
    ``_f64_reference`` semantics."""
    from numpy.lib.stride_tricks import sliding_window_view

    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mask = np.asarray(mask, bool)
    rows, L = x.shape
    out = {k: np.full((rows, L), np.nan)
           for k in ("mean_x", "mean_y", "cov", "var_x", "var_y")}
    valid = np.zeros((rows, L), bool)
    if window > L:
        out["valid"] = valid
        return out
    step = max(1, chunk_elems // max(1, L * window))
    for r0 in range(0, rows, step):
        sl = slice(r0, r0 + step)
        xw = sliding_window_view(x[sl], window, axis=-1)
        yw = sliding_window_view(y[sl], window, axis=-1)
        mw = sliding_window_view(mask[sl], window, axis=-1).all(-1)
        mx, my = xw.mean(-1), yw.mean(-1)
        dx, dy = xw - mx[..., None], yw - my[..., None]
        tail = slice(window - 1, L)
        for k, v in (("mean_x", mx), ("mean_y", my),
                     ("cov", (dx * dy).mean(-1)),
                     ("var_x", (dx * dx).mean(-1)),
                     ("var_y", (dy * dy).mean(-1))):
            out[k][sl, tail] = np.where(mw, v, np.nan)
        valid[sl, tail] = mw
    out["valid"] = valid
    return out


def check_cpu(case) -> None:
    """The plain version's window statistics on the CPU against the f64
    oracle on the case's first :data:`CPU_ROWS` rows."""
    from ..ops import rolling

    low = case["low"][:CPU_ROWS]
    high = case["high"][:CPU_ROWS]
    mask = case["mask"][:CPU_ROWS]
    w = case["window"]
    st = {k: v.numpy() for k, v in rolling.rolling_window_stats(
        torch.from_numpy(low), torch.from_numpy(high),
        torch.from_numpy(mask), w, impl="torch").items()}
    ref = f64_window_stats(low, high, mask, w)
    label = f"plain [{low.shape[0]}, {low.shape[1]}] window {w}"
    if not np.array_equal(st["valid"], ref["valid"]):
        raise AssertionError(f"{label}: valid windows differ from f64")
    v = ref["valid"]
    xc, yc, _, _ = rolling.second_moment_inputs(
        torch.from_numpy(low), torch.from_numpy(high),
        torch.from_numpy(mask), w)
    allow = rounding_allowance(ref, w, _row_max(xc, mask),
                               _row_max(yc, mask))
    for k in ("mean_x", "mean_y"):
        a, b = st[k], ref[k]
        bad = v & ~(np.abs(a - b) <= ROLLING_ATOL + ROLLING_RTOL * np.abs(b))
        if bad.any():
            raise AssertionError(f"{label}: {k} out of tolerance at "
                                 f"{int(bad.sum())} lanes")
    _close(label, st, ref, v, allow)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _raises_cleanly(label, fn, tensors, window, probe) -> None:
    """``fn(*tensors, window)`` must raise; the tensors keep their bits
    and ``probe()`` (a valid launch of each kernel) still runs after."""
    dev = tensors[0].device
    before = [t.clone() for t in tensors]
    try:
        fn(*tensors, window)
        _sync(dev)
    except (RuntimeError, ValueError):
        pass
    else:
        raise AssertionError(f"{label}: did not raise")
    for a, b in zip(tensors, before):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{label}: an input changed")
    try:
        probe()
        _sync(dev)
    except RuntimeError as e:
        raise AssertionError(f"{label}: the next valid launch failed "
                             f"({e})") from None


def _probe(dev):
    """A small valid launch of each kernel."""
    from ..ops import rolling_cuda

    t = torch.ones(2, 64, device=dev)
    rolling_cuda.second_moments(t, t, t, t, rolling_cuda.TILED_WINDOW)
    rolling_cuda._second_moments_rowwise(t, t, t, t, 3)


def check_cuda(case, dev) -> None:
    """Both kernels on the card against the plain version and each
    other; beyond-span shapes and misaligned views must raise cleanly."""
    from ..ops import rolling, rolling_cuda

    w = case["window"]
    low, high, mask = (torch.from_numpy(case[k]).to(dev)
                       for k in ("low", "high", "mask"))
    rows, L = low.shape
    args = rolling.second_moment_inputs(low, high, mask, w)
    valid = (rolling._windowed_sum(mask, w) > w - 0.5).cpu().numpy()
    label = f"[{rows}, {L}] window {w}"
    tiled_ok = w == rolling_cuda.TILED_WINDOW and L <= SPAN_MAX
    rowwise_ok = L + w - 1 <= SPAN_MAX
    if w == rolling_cuda.TILED_WINDOW and not tiled_ok:
        _raises_cleanly(f"tiled {label}", rolling_cuda.second_moments,
                        args, w, lambda: _probe(dev))
    if not rowwise_ok:
        _raises_cleanly(f"rowwise {label}",
                        rolling_cuda._second_moments_rowwise, args, w,
                        lambda: _probe(dev))
    if not (tiled_ok or rowwise_ok):
        return
    plain = _stats(rolling_cuda.second_moments_plain(*args, w), w)
    allow = rounding_allowance(plain, w)
    got = {}
    if tiled_ok:
        got["tiled"] = rolling_cuda.second_moments(*args, w)
    if rowwise_ok:
        got["rowwise"] = rolling_cuda._second_moments_rowwise(*args, w)
    _sync(dev)
    if len(got) == 2:
        for name, a, b in zip(("s_xx", "s_yy", "s_xy"), got["tiled"],
                              got["rowwise"]):
            neq = a.view(torch.int32) != b.view(torch.int32)
            if bool(neq.any()):
                raise AssertionError(
                    f"{label}: tiled {name} differs from rowwise at "
                    f"{int(neq.sum())} of {neq.numel()} lanes")
    for kind, moments in got.items():
        st = _stats(moments, w)
        for s in ("s_xx", "s_yy"):
            z = valid & ((st[s] == 0) != (plain[s] == 0))
            if z.any():
                raise AssertionError(
                    f"{kind} {label}: {s} is exactly zero on other lanes "
                    f"than the plain version's ({int(z.sum())})")
        _close(f"{kind} {label}", st, plain, valid, allow)
    if tiled_ok and rows and L > 1:
        # a view one float into its storage: the tiled kernel reads
        # 16-byte vectors and must refuse it
        base = [torch.empty(rows * L + 1, device=dev) for _ in range(4)]
        views = []
        for b, a in zip(base, args):
            b[1:].copy_(a.reshape(-1))
            views.append(b[1:].view(rows, L))
        _raises_cleanly(f"tiled misaligned {label}",
                        rolling_cuda.second_moments, views, w,
                        lambda: _probe(dev))


def check_case(seed: int, dev, card=None) -> None:
    """Case ``seed``: the card path on a CUDA ``dev``, else the CPU path
    (``card`` overrides, to rehearse the card path on stand-in kernels)."""
    case = scenarios.rolling_case(seed)
    if dev.type == "cuda" if card is None else card:
        check_cuda(case, dev)
    else:
        check_cpu(case)


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    dev = device_of(device)
    return sweep("rolling", range(lo, hi), lambda s: check_case(s, dev),
                 every=50)
