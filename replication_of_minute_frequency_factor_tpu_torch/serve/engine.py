"""Device-facing serve compute: block builds and query graphs.

The port of the JAX package's ``serve/engine.py``. One *block* is
everything the service needs to answer any query over a day-range: the
stacked ``[F, D, T]`` exposures of the server's factor set plus the
per-(day, ticker) daily close and validity planes the IC and decile
queries derive forward returns from, and the ``[F, 9]`` factor-stats
sketch. A block is built by ONE call (wire unpack + decode + all factors
+ close extraction + stats, the same shape as
``pipeline.compute_packed_prepared``) and stays on the device; the
service's exposure cache owns its lifetime. A block build runs the whole
factor graph, so with ``rolling_impl='cuda'`` on the card it launches the
rolling second-moment kernel once.

Every entry point here goes through the
:class:`..serve.executables.ExecutableCache`, keyed on the device and on
every static argument the JAX package's key holds; its
``serve.executables{outcome=miss}`` counter counts the keys a request
added. What a request really builds is counted by
:func:`..kernels.build_count` (``nvcc`` runs and library loads): an
engine on a card loads the kernel libraries it launches once, at
construction (the pv_corr family's always, the rolling moments' with
``rolling_impl='cuda'``), so a warm server builds NOTHING on any request — the gate the JAX
package's ``xla.compiles`` is there.

Results leave as device tensors, enqueued and not waited for; the
request loop in :mod:`.service` is the boundary that fetches them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import result_wire
from ..data import wire
from ..eval_ops import _qcut_labels, ic_series
from ..telemetry.factorplane import factor_stats_block
from .executables import ExecutableCache


def _block_fn(buf, spec, kind, names, replicate_quirks, rolling_impl,
              session=None, tracer=None):
    """The block graph: one packed uint8 buffer (on the device) in, the
    whole query-answering state out. ``close`` is each (day, ticker)'s
    last valid bar's close (NaN when the day has no valid bar) — the
    basis for the forward returns IC/decile queries correlate against.
    ``stats`` is the per-factor data-quality sketch of the same
    exposures. The decode and the stacked factors are the packed path's
    own, with their spans on ``tracer``."""
    from ..pipeline import _decode, _stacked

    bars, m = _decode(buf, spec, kind, tracer)
    exposures = _stacked(bars, m, names, session, rolling_impl,
                         replicate_quirks, tracer=tracer)  # [F, D, T]
    slots = torch.arange(m.shape[-1], device=m.device)
    last = torch.where(m, slots, -1).amax(dim=-1)  # [D, T]
    valid = last >= 0
    close = torch.gather(bars[..., 3], -1,
                         last.clamp(min=0)[..., None])[..., 0]
    close = torch.where(valid, close, float("nan"))
    return exposures, close, valid, factor_stats_block(exposures)


def _fwd_returns(close, valid, horizon: int):
    """``ret[d] = close[d+h]/close[d] - 1`` with the last ``h`` days
    invalid (no forward close inside the block)."""
    pad_c = torch.full((horizon,) + tuple(close.shape[1:]), float("nan"),
                       dtype=close.dtype, device=close.device)
    pad_v = torch.zeros((horizon,) + tuple(valid.shape[1:]),
                        dtype=torch.bool, device=valid.device)
    fwd_close = torch.cat([close[horizon:], pad_c])
    fwd_ok = torch.cat([valid[horizon:], pad_v])
    ret = fwd_close / close - 1.0
    return ret, fwd_ok & valid


def _ic_fn(exposures, close, valid, row, horizon):
    """Per-date Pearson IC + Spearman rank-IC of factor ``row`` against
    ``horizon``-day forward close returns, inside the block."""
    exp = exposures[row]
    ret, ok = _fwd_returns(close, valid, horizon)
    v = ok & torch.isfinite(exp) & torch.isfinite(ret)
    return ic_series(torch.where(v, exp, 0.0), torch.where(v, ret, 0.0), v)


def _encode_exposures_fn(exposures, result_spec):
    """Result-wire encode of a block's stacked exposures: the answer
    leg's device half. Encodes from the cache's RAW f32 block every time
    — the cache never holds quantized data, so repeated answers can
    never re-quantize a decode, and the encode is deterministic on the
    same block."""
    return result_wire.encode_block(exposures, result_spec)


def _decile_fn(exposures, close, valid, row, horizon, group_num):
    """Per-date quantile buckets of factor ``row`` (polars-qcut
    semantics via eval_ops) with per-bucket counts and mean forward
    returns."""
    exp = exposures[row]
    v = valid & torch.isfinite(exp)
    labels = _qcut_labels(exp, v, group_num)  # [D, T], -1 invalid
    ret, ok = _fwd_returns(close, valid, horizon)
    buckets = torch.arange(group_num, dtype=labels.dtype,
                           device=labels.device)
    onehot = labels[..., None] == buckets  # [D, T, G]
    counts = (onehot & v[..., None]).sum(dim=1, dtype=torch.int32)
    okr = onehot & (ok & torch.isfinite(ret) & v)[..., None]
    n_ret = okr.sum(dim=1, dtype=torch.int32)
    ret_sum = torch.where(okr, ret[..., None], 0.0).sum(dim=1)
    mean_ret = torch.where(n_ret > 0, ret_sum / n_ret, float("nan"))
    return labels, counts, mean_ret


class ServeEngine:
    """Builds and queries blocks for one server's factor set.

    Holds the widen-only wire ``floor`` across blocks (so same-extent
    day-ranges converge on one spec — and therefore ONE built block
    callable) and the :class:`ExecutableCache` all dispatches go
    through. ``device`` defaults to ``cuda`` and raises when no card is
    present; pass ``device='cpu'`` to run on the CPU.
    """

    def __init__(self, names: Sequence[str], replicate_quirks: bool = True,
                 rolling_impl: Optional[str] = None, telemetry=None,
                 executables: Optional[ExecutableCache] = None,
                 session=None, device=None):
        from ..config import get_config
        from ..markets import get_session
        from ..pipeline import resolve_device
        self.device = resolve_device(device)
        #: the source's market session: the block graph and every query
        #: run over its slot grid; None = cn_ashare_240
        self.session = get_session(session)
        self.names: Tuple[str, ...] = tuple(names)
        self.replicate_quirks = replicate_quirks
        self.rolling_impl = (rolling_impl if rolling_impl is not None
                             else get_config().rolling_impl)
        self.telemetry = telemetry
        self.executables = (executables if executables is not None
                            else ExecutableCache(telemetry=telemetry))
        self._floor: dict = {}
        if self.device.type == "cuda":
            from .. import kernels
            kernels.load("pv_corr")
            if self.rolling_impl == "cuda":
                kernels.load("rolling_moments")

    def _tel(self):
        if self.telemetry is not None:
            return self.telemetry
        from ..telemetry import get_telemetry
        return get_telemetry()

    def _exe(self, label: str, key: tuple, fn):
        """The cached callable for ``key`` (the device always in it); a
        miss binds ``fn``."""
        return self.executables.get(label, key + (str(self.device),),
                                    lambda: fn)

    # --- block build ----------------------------------------------------
    def build_block(self, bars: np.ndarray,
                    mask: np.ndarray) -> Dict[str, torch.Tensor]:
        """Encode + copy + one block call; returns the block as DEVICE
        tensors ``{exposures, close, valid, stats}``. The work is
        enqueued, not waited for — errors of the device surface when the
        service fetches an answer from it."""
        w = wire.encode(bars, mask, floor=self._floor)
        if w is not None:
            buf, spec = wire.pack_arrays(w.arrays)
            kind = "wire"
        else:
            buf, spec = wire.pack_arrays((bars, mask.view(np.uint8)))
            kind = "raw"
        dbuf = torch.from_numpy(buf).to(self.device)
        key = ("block", len(buf), spec, kind, self.names,
               self.replicate_quirks, self.rolling_impl,
               self.session.name)
        fn = self._exe("serve_block", key, functools.partial(
            _block_fn, spec=spec, kind=kind, names=self.names,
            replicate_quirks=self.replicate_quirks,
            rolling_impl=self.rolling_impl, session=self.session,
            tracer=self._tel().tracer))
        exposures, close, valid, stats = fn(dbuf)
        block = {"exposures": exposures, "close": close, "valid": valid,
                 "stats": stats}
        # device bytes this block pins (shape metadata, not a sync): the
        # signal the exposure-cache LRU budget is set against
        self._tel().gauge("serve.block_bytes", sum(
            int(v.nbytes) for v in block.values()))
        return block

    # --- queries (device in, device out) --------------------------------
    def row(self, name: str) -> int:
        return self.names.index(name)

    def ic(self, block: Dict[str, torch.Tensor], name: str, horizon: int):
        """Device ``(ic [D], rank_ic [D])`` for one factor."""
        exposures = block["exposures"]
        row = self.row(name)
        key = ("ic", tuple(exposures.shape), row, horizon)
        fn = self._exe("serve_ic", key, functools.partial(
            _ic_fn, row=row, horizon=horizon))
        return fn(exposures, block["close"], block["valid"])

    def result_spec(self, days: int) -> "result_wire.ResultWireSpec":
        """The server's static result-wire spec for a ``days``-deep
        block (pinned per-factor bounds + the default spill budget)."""
        return result_wire.ResultWireSpec.for_names(self.names,
                                                    days=days)

    def encode_exposures(self, block: Dict[str, torch.Tensor]):
        """Result-wire encode of the block's ``[F, D, T]`` exposures as
        ONE warm call -> packed ``[L] uint8`` payload (still on the
        device; the request loop fetches + host-dequantizes it). Always
        encodes from the cached RAW f32 exposures."""
        exposures = block["exposures"]
        spec = self.result_spec(int(exposures.shape[1]))
        key = ("result_encode", tuple(exposures.shape), spec)
        fn = self._exe("serve_result_encode", key, functools.partial(
            _encode_exposures_fn, result_spec=spec))
        return fn(exposures), spec

    def decile(self, block: Dict[str, torch.Tensor], name: str,
               horizon: int, group_num: int):
        """Device ``(labels [D, T], counts [D, G], mean_fwd_ret
        [D, G])`` for one factor."""
        exposures = block["exposures"]
        row = self.row(name)
        key = ("decile", tuple(exposures.shape), row, horizon, group_num)
        fn = self._exe("serve_decile", key, functools.partial(
            _decile_fn, row=row, horizon=horizon, group_num=group_num))
        return fn(exposures, block["close"], block["valid"])
