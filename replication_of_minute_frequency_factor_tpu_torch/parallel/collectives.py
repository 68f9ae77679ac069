"""Cross-sectional collectives over a sharded ticker axis.

The port of the JAX package's ``parallel/collectives.py``. The only
operations that need communication are the per-date cross-sectional
statistics of evaluation (IC, quantile cuts), the ``doc_pdf*`` family's
whole-frame rank, and the 2-D resident loop's cross-day carry handoff.
Everything else (all 58 kernels but the ``doc_pdf*`` rank) is per
(ticker, day) and runs with no collective.

* moment statistics (mean/std/corr) are an all-reduce of local partial
  sums, as the JAX package psums them;
* order statistics (rank, quantile cut) all-gather the ``[.., T_local]``
  cross-section, rank the whole frame locally (every rank ranks the
  identical frame, so the result is bitwise the single-device op) and
  slice this rank's lanes back out.

Functions suffixed ``_local`` are the per-rank bodies: each takes this
rank's block and the NAME of the mesh axis it is sharded over, resolved
through the active mesh (``with mesh:``), as a JAX axis name resolves
through the enclosing ``shard_map``. The unsuffixed wrappers take the
mesh and this rank's ``[dates, T_local]`` blocks, count the dispatch in
``mesh.collective_dispatches{label=}`` and span it as
``collective.<label>`` with ``kind=host_dispatch``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..models.registry import compute_factors
from ..ops import rank_average
from ..ops.ranking import _canonical_key
from ..telemetry import get_telemetry
from . import transport
from .mesh import DAYS_AXIS, TICKERS_AXIS, Mesh, current_mesh

_NAN = float("nan")
_NO_LANE = 2**30  # "no valid lane on this rank" index sentinel


def axis_group(axis_name: str):
    """``(group, size, index)`` of the active mesh's ``axis_name``."""
    mesh = current_mesh()
    return (mesh.group(axis_name), mesh.axis_size(axis_name),
            mesh.axis_index(axis_name))


def _psum(tensors, axis_name):
    """One fused all-reduce (SUM) of several same-dtype tensors."""
    group, _, _ = axis_group(axis_name)
    if group is None:
        return tuple(tensors)
    shapes = [t.shape for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = transport.all_reduce(flat, dist.ReduceOp.SUM, group)
    out, off = [], 0
    for s in shapes:
        n = int(torch.Size(s).numel())
        out.append(flat[off:off + n].reshape(s))
        off += n
    return tuple(out)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def xs_reduce_local(x, op: str, axis_name=TICKERS_AXIS):
    """``x`` reduced elementwise (``op`` 'sum', 'min' or 'max') over
    the ranks of ``axis_name``: the side outputs' cross-rank reductions
    (the result wire's per-slice min/max, the stats sketch's counts,
    sums and extremes). min/max and integer-valued sums are exact;
    float sums are in the transport's order."""
    group, _, _ = axis_group(axis_name)
    if group is None:
        return x
    return transport.all_reduce(x, _OPS[op], group)


# --------------------------------------------------------------------------
# all-reduce-based masked moments
# --------------------------------------------------------------------------

def _count_mean_many(arrays, mask, axis_name):
    """Global count and per-array masked means over the sharded last
    axis, ``(n, mean_0, mean_1, ...)``; means NaN if n=0. The count
    rides the same fused all-reduce as the sums, in f32 (exact below
    2^24 lanes)."""
    n, *sums = _psum(
        (mask.sum(dim=-1, dtype=torch.float32),)
        + tuple(torch.where(mask, a, 0.0).sum(dim=-1) for a in arrays),
        axis_name)
    nn = n.clamp(min=1)
    return (n,) + tuple(torch.where(n > 0, s / nn, _NAN) for s in sums)


def _first_valid_many(arrays, mask, axis_name):
    """Values at the globally first valid lane of the sharded
    cross-section (NaN if none): each rank offers its first valid GLOBAL
    column, a MIN all-reduce picks the winner, one SUM all-reduce of the
    one-hot-selected values broadcasts them."""
    group, _, idx = axis_group(axis_name)
    t_local = mask.shape[-1]
    gcol = torch.arange(t_local, dtype=torch.int32,
                        device=mask.device) + idx * t_local
    gidx = torch.where(mask, gcol, _NO_LANE)
    gmin = gidx.amin(dim=-1)
    if group is not None:
        gmin = transport.all_reduce(gmin, dist.ReduceOp.MIN, group)
    here = gidx == gmin[..., None]
    vals = _psum(tuple(torch.where(here, a, 0.0).sum(dim=-1)
                       for a in arrays), axis_name)
    has = gmin < _NO_LANE
    return tuple(torch.where(has, v, _NAN) for v in vals)


def xs_masked_mean_local(x, mask, axis_name=TICKERS_AXIS):
    _, mean = _count_mean_many((x,), mask, axis_name)
    return mean


def xs_masked_std_local(x, mask, axis_name=TICKERS_AXIS, ddof: int = 1):
    """Cross-rank masked std, polars default ddof=1: two-pass like
    ``ops.masked.masked_std`` (all-reduced mean, then the all-reduced sum
    of squared deviations)."""
    n, mean = _count_mean_many((x,), mask, axis_name)
    d = torch.where(mask, x - mean[..., None], 0.0)
    (m2,) = _psum(((d * d).sum(dim=-1),), axis_name)
    var = torch.where(n > ddof, m2 / (n - ddof).clamp(min=1), _NAN)
    return torch.sqrt(var)


def xs_pearson_local(x, y, mask, axis_name=TICKERS_AXIS):
    """Masked Pearson correlation across the sharded axis (per leading
    row), mirroring ``ops.masked.masked_corr``: both series anchored to
    their globally first valid value, then two-pass moments."""
    ax, ay = _first_valid_many((x, y), mask, axis_name)
    x = x - ax[..., None]
    y = y - ay[..., None]
    n, mx, my = _count_mean_many((x, y), mask, axis_name)
    dx = torch.where(mask, x - mx[..., None], 0.0)
    dy = torch.where(mask, y - my[..., None], 0.0)
    cov, vx, vy = _psum(((dx * dy).sum(dim=-1), (dx * dx).sum(dim=-1),
                         (dy * dy).sum(dim=-1)), axis_name)
    r = cov / torch.sqrt(vx * vy)  # zero variance -> NaN, as polars
    return torch.where(n > 1, r, _NAN)


# --------------------------------------------------------------------------
# all-gather-based order statistics
# --------------------------------------------------------------------------

def _gather_compute_slice(fn, x, mask, axis_name):
    """All-gather the cross-section along the last axis, ``fn`` on the
    whole frame, this rank's lanes sliced back out."""
    group, _, idx = axis_group(axis_name)
    full_x = transport.all_gather(x, group, dim=-1)
    full_m = transport.all_gather(mask, group, dim=-1)
    r = fn(full_x, full_m)
    t = x.shape[-1]
    return r[..., idx * t:(idx + 1) * t]


def xs_rank_local(x, mask, axis_name=TICKERS_AXIS):
    """Average-tie rank among the valid lanes of the whole
    cross-section, this rank's lanes."""
    return _gather_compute_slice(rank_average, x, mask, axis_name)


def xs_global_rank_local(x, mask, axis_name=TICKERS_AXIS):
    """Average-tie rank of a FLATTENED sharded frame: the sharded twin of
    ``DayContext.eod_ret_global_rank`` (the ``doc_pdf*`` family's
    whole-day-frame rank, the one cross-ticker intermediate in the 58
    kernels). ``x``/``mask`` are ``[..., T_local * S]``, this rank's
    tickers flattened ticker-major, so the gather along the last axis
    reassembles exactly the single-device flatten order. Bitwise the
    single-device rank: every rank ranks the identical frame."""
    return _gather_compute_slice(rank_average, x, mask, axis_name)


def xs_qcut_local(x, mask, group_num: int, axis_name=TICKERS_AXIS):
    """Per-date quantile-bucket labels over a sharded cross-section:
    the single-device qcut core (``eval_ops._qcut_labels``) on the
    gathered matrix, this rank's lanes back; bitwise the unsharded
    labels."""
    from .. import eval_ops

    return _gather_compute_slice(
        lambda a, m: eval_ops._qcut_labels(a, m, group_num), x, mask,
        axis_name)


def xs_population_topk_local(stats_local, k: int, n_pop: int,
                             axis_name=TICKERS_AXIS):
    """End-of-generation top-k of a population sharded over
    ``axis_name``: ``stats_local [P_local, 4]`` (column 0 = fitness) is
    gathered in shard order to ``[P_pad, 4]``, rows at or past ``n_pop``
    (shard padding) masked to -inf, NaN fitness below every finite one
    (``nan_to_num(-1)``), and every rank takes the identical top-k,
    ``lax.top_k``'s selection (ties to the lower index) from one stable
    sort of the negated integer order key, as the single-device
    generation takes it (``research.fitness.device_topk``).
    Returns ``(stats [P_pad, 4], top_vals [k], top_idx [k])``."""
    group, _, _ = axis_group(axis_name)
    full = transport.all_gather(stats_local, group, dim=0)
    fit = torch.nan_to_num(full[:, 0], nan=-1.0)
    pos = torch.arange(fit.shape[0], device=fit.device)
    fit = torch.where(pos < n_pop, fit, float("-inf"))
    key = -_canonical_key(fit).to(torch.int64)
    top_idx = torch.sort(key, stable=True).indices[:k]
    return full, fit[top_idx], top_idx


def xs_carry_handoff_local(state, combine, axis_name=DAYS_AXIS,
                           axis_size: int = 1):
    """Cross-day carry handoff between day-shards: every rank's
    end-of-span state combined into the global prefix state, the same on
    every rank of the axis.

    The JAX package runs ``ceil(log2(d))`` doubling ring ``ppermute``
    legs. Here each leaf is all-gathered over the axis and the states
    are folded in rank order; both give the same answer because
    ``combine`` is associative, commutative and idempotent
    (``stream.carry.combine_span_state``). A one-rank axis is the
    identity. Dispatch counting lives with the caller
    (``mesh.collective_dispatches{label=carry_handoff}``), once per
    call as in the JAX package."""
    group, size, _ = axis_group(axis_name)
    if group is None or size == 1:
        return state
    keys = list(state)
    gathered = {k: transport.all_gather(state[k].unsqueeze(0), group,
                                        dim=0) for k in keys}
    out = {k: gathered[k][0] for k in keys}
    for r in range(1, size):
        out = combine(out, {k: gathered[k][r] for k in keys})
    return out


# --------------------------------------------------------------------------
# wrappers for [dates, tickers] blocks
# --------------------------------------------------------------------------

def _xs_wrap(body, label: str):
    """``body`` run under ``mesh`` on this rank's blocks, counted in
    ``mesh.collective_dispatches{label=}`` and spanned as
    ``collective.<label>`` with ``kind=host_dispatch`` (host time to
    enqueue the collective, not on-device collective time)."""

    def run(mesh: Mesh, *arrays):
        tel = get_telemetry()
        tel.meshplane.note_collective(label)
        with tel.tracer(f"collective.{label}", kind="host_dispatch"), mesh:
            return body(*arrays)

    run.__name__ = label
    return run


xs_masked_mean = _xs_wrap(xs_masked_mean_local, "xs_masked_mean")
xs_masked_std = _xs_wrap(xs_masked_std_local, "xs_masked_std")
xs_pearson = _xs_wrap(xs_pearson_local, "xs_pearson")
xs_rank = _xs_wrap(xs_rank_local, "xs_rank")


def xs_qcut(mesh: Mesh, x, m, group_num: int = 5):
    """Sharded per-date quantile-bucket labels (:func:`xs_qcut_local`),
    counted and spanned as :func:`_xs_wrap` does."""
    tel = get_telemetry()
    tel.meshplane.note_collective("xs_qcut")
    with tel.tracer("collective.xs_qcut", kind="host_dispatch"), mesh:
        return xs_qcut_local(x, m, group_num)


# --------------------------------------------------------------------------
# sharded factor computation
# --------------------------------------------------------------------------

def sharded_compute_factors(
    bars, mask, mesh: Mesh,
    names: Optional[Tuple[str, ...]] = None,
    replicate_quirks: bool = True,
    rolling_impl: Optional[str] = None,
    session=None,
):
    """The named factors (default: all 58) over this rank's block of a
    mesh-sharded day batch (:func:`..parallel.mesh.shard_day_batch`):
    ``{name: [D_local, T_local]}`` on this rank's device. Per-(ticker,
    day) kernels run with no collective; the ``doc_pdf*`` rank gathers
    over the tickers axis. A None ``rolling_impl`` reads the config."""
    if rolling_impl is None:
        from ..config import get_config
        rolling_impl = get_config().rolling_impl
    tel = get_telemetry()
    tel.counter("collective.sharded_factor_batches")
    with tel.tracer("collective.sharded_factors", kind="host_dispatch"), \
            mesh:
        return compute_factors(bars, mask, names=names,
                               replicate_quirks=replicate_quirks,
                               rolling_impl=rolling_impl,
                               xs_axis_name=TICKERS_AXIS, session=session)
