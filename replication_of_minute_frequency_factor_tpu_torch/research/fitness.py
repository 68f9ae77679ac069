"""Fused per-generation backtest fitness: evaluation IS the fitness.

The port of the JAX package's ``research/fitness.py``. One generation of
the discovery loop evaluates the whole candidate population into
per-candidate exposures ``[P, D, T]`` (:func:`..search.evaluate_plan`),
then, without leaving the device, the per-date cross-sectional
Pearson/rank IC (:func:`..eval_ops.ic_series`) and the decile long-short
spread (:func:`..eval_ops.decile_spread`, the production qcut core)
reduce each candidate to four scalars. Nothing is fetched between
evaluation and fitness; the host sees one ``[P, 4]`` stats matrix per
generation (the evolutionary loop's single labelled sync, :mod:`.evolve`).

Device memory stays bounded like :func:`..search.fitness`: populations
larger than ``chunk`` go through a Python loop over chunk-sized slices
(where the JAX package runs one ``lax.map``); the last chunk is short
where the chunk does not divide the population, which gives the padded
chunk's values, since each candidate's values do not depend on its
neighbours. The plans of every chunk go to the device in one copy.

The device top-k of the generation is one stable descending sort of the
fitness with NaN as -1 (the order of ``lax.top_k``, which breaks ties by
the lower index; ``torch.topk`` on the card promises no order among
ties), on an integer key, so the card and the CPU select alike.

Nothing here waits for the device: no ``.item()``, no boolean-mask
indexing, no ``nonzero``, and the index upload is a non-blocking copy
from pinned memory (``tests/test_torch_cuda.py`` runs a generation under
``torch.cuda.set_sync_debug_mode("error")``).

The population-sharded generation (:func:`generation_fitness_sharded`)
runs the same body on each shard of an in-process mesh, on its block of
the padded population against its own copy of the feature bank, then the
one collective: the end-of-generation top-k gather
(``parallel.collectives.xs_population_topk_local``).

Stats column order (the ``[P, 4]`` matrix): ``fitness`` (=|mean IC|, the
selection scalar — NaN when no date produced an IC), ``mean_ic``
(signed), ``mean_rank_ic`` (signed Spearman), ``spread`` (mean decile
long-short spread).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import search
from ..eval_ops import decile_spread, ic_series
from ..ops.ranking import _canonical_key

#: stats-matrix column order (see module docstring)
STAT_COLUMNS = ("fitness", "mean_ic", "mean_rank_ic", "spread")

def host_forward_returns(bars: np.ndarray, mask: np.ndarray,
                         horizon: int = 1
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side ``(fwd_ret [D, T], fwd_valid [D, T])`` from a day
    slab: each day's last present bar's close, then
    ``close[d+h]/close[d] - 1`` with the final ``h`` days invalid —
    numpy-on-numpy (the slab is already host data in every discovery
    caller), the serve engine's ``_fwd_returns`` semantics. A copy of
    the JAX package's function, pinned to its output by
    tests/test_torch_research.py."""
    bars = np.ascontiguousarray(bars, np.float32)
    mask = np.ascontiguousarray(mask, bool)
    slots = np.arange(mask.shape[-1])
    last = np.max(np.where(mask, slots, -1), axis=-1)       # [D, T]
    valid = last >= 0
    close = np.take_along_axis(
        bars[..., 3], np.maximum(last, 0)[..., None], axis=-1)[..., 0]
    close = np.where(valid, close, np.nan).astype(np.float32)
    h = int(horizon)
    pad_c = np.full((h,) + close.shape[1:], np.nan, np.float32)
    pad_v = np.zeros((h,) + valid.shape[1:], bool)
    fwd_close = np.concatenate([close[h:], pad_c])
    fwd_ok = np.concatenate([valid[h:], pad_v])
    with np.errstate(invalid="ignore", divide="ignore"):
        ret = (fwd_close / close - 1.0).astype(np.float32)
    return ret, fwd_ok & valid


def _candidate_stats(vals, fwd_ret, fwd_valid, group_num: int):
    """The fused body for one population slice: exposures ``[p, D, T]``
    -> ``[p, 4]`` stats."""
    valid = torch.isfinite(vals) & fwd_valid
    x = torch.where(valid, vals, 0.0)
    y = torch.where(valid, fwd_ret, 0.0)
    ic, rank_ic = ic_series(x, y, valid)                      # [p, D] x2
    mean_ic = torch.nanmean(ic, dim=-1)
    mean_rank_ic = torch.nanmean(rank_ic, dim=-1)
    spread = decile_spread(vals, fwd_ret.expand_as(vals), valid,
                           group_num)                          # [p, D]
    mean_spread = torch.nanmean(spread, dim=-1)
    fitness = mean_ic.abs()  # the selection scalar (search.fitness)
    return torch.stack([fitness, mean_ic, mean_rank_ic, mean_spread],
                       dim=-1)


def generation_stats(genomes, feats, mask, fwd_ret, fwd_valid,
                     skeleton: Tuple[int, ...], group_num: int = 5,
                     chunk: Optional[int] = None):
    """One generation's fused fitness: ``[P, L]`` int32 host genomes ->
    ``[P, 4]`` f32 stats on the feature bank's device (column order
    :data:`STAT_COLUMNS`).

    ``feats`` is the day slab's feature bank (``search._features``),
    computed once per job; ``chunk`` bounds the live ``[chunk, D, T, S]``
    stack temporaries (default: :func:`..search.auto_chunk` of the
    day-tensor shape).
    """
    g = search._host_genomes(genomes)
    if chunk is None:
        chunk = search.auto_chunk(tuple(mask.shape))
    bounds = search.chunk_bounds(len(g), chunk)
    plans = search.upload_plans(
        [search.slot_groups(g[a:b], skeleton) for a, b in bounds],
        feats.device)
    out = [_candidate_stats(search.evaluate_plan(plan, feats, mask,
                                                 skeleton, b - a),
                            fwd_ret, fwd_valid, group_num)
           for (a, b), plan in zip(bounds, plans)]
    return torch.cat(out)


def device_topk(fit, n_elite: int):
    """``(values, indices)`` of the ``n_elite`` largest fitnesses, NaN as
    -1, ties to the lower index: ``lax.top_k``'s selection, from one
    stable ascending sort of the negated integer order key."""
    fit = torch.nan_to_num(fit, nan=-1.0)
    key = -_canonical_key(fit).to(torch.int64)
    idx = torch.sort(key, stable=True).indices[:n_elite]
    return fit[idx], idx


def generation_fitness(genomes, feats, mask, fwd_ret, fwd_valid,
                       skeleton: Tuple[int, ...] = search.DEFAULT_SKELETON,
                       group_num: int = 5, chunk: Optional[int] = None,
                       n_elite: int = 2):
    """Single-device generation: ``(stats [P, 4], top_vals [k],
    top_idx [k])`` device tensors, enqueued and not waited for (NaN
    fitness ranks below every finite candidate, as host selection's
    ``nan_to_num(-1)``)."""
    stats = generation_stats(genomes, feats, mask, fwd_ret, fwd_valid,
                             skeleton, group_num, chunk)
    top_vals, top_idx = device_topk(stats[:, 0], n_elite)
    return stats, top_vals, top_idx


def _replicas(x, mesh) -> list:
    """One copy of a replicated device argument a shard: a per-shard
    sequence as it is, a tensor copied to each shard's device."""
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x.to(d) for d in mesh.devices]


def generation_fitness_sharded(genomes, feats, mask, fwd_ret, fwd_valid,
                               mesh,
                               skeleton: Tuple[int, ...] =
                               search.DEFAULT_SKELETON,
                               group_num: int = 5,
                               chunk: Optional[int] = None,
                               n_elite: int = 2,
                               n_pop: Optional[int] = None):
    """Population-sharded generation over an in-process tickers mesh
    (``parallel.resident_mesh(n, devices=[...])``): ``(stats [P_pad, 4],
    top_vals [k], top_idx [k])`` on the mesh's first device, enqueued and
    not waited for.

    ``genomes [P_pad, L]`` (host) are cut into one contiguous block a
    shard (``P_pad`` a multiple of the shard count; ``n_pop`` the logical
    population, default ``P_pad``: pad rows at or past it are masked to
    -inf before the top-k, so a pad genome is never selected). The device
    arguments are replicated: a per-shard sequence (as
    :meth:`.evolve.DiscoveryEngine.prepare` places them) or one tensor,
    copied to each shard's device. Each shard runs
    :func:`generation_stats` on its block; then every shard gathers the
    stats and takes the same top-k. At the chunk of the shard's block,
    each shard's stats are bitwise the single-device generation's rows.
    """
    from ..parallel.collectives import xs_population_topk_local
    from ..parallel.mesh import TICKERS_AXIS

    g = search._host_genomes(genomes)
    n = mesh.shape[TICKERS_AXIS]
    if len(g) % n:
        raise ValueError(f"a population of {len(g)} does not divide over "
                         f"{n} shards: pad it to a multiple")
    n_pop = len(g) if n_pop is None else int(n_pop)
    blk = len(g) // n

    def body(view, g_local, f, m, fr, fv):
        local = generation_stats(g_local, f, m, fr, fv, skeleton,
                                 group_num, chunk)
        return xs_population_topk_local(local, n_elite, n_pop,
                                        axis_name=TICKERS_AXIS)

    outs = mesh.run(body, [g[i * blk:(i + 1) * blk] for i in range(n)],
                    *(_replicas(x, mesh)
                      for x in (feats, mask, fwd_ret, fwd_valid)))
    return outs[0]
