"""Tier B for the port: an ATen op trace of every registered kernel.

The JAX package's Tier B abstractly traces each kernel to a jaxpr and
walks it. Eager torch has no graph to walk, so this tier RUNS each
kernel once on seeded inputs at the canonical ``(days=2, tickers=3,
240)`` layout, on ``DayContext(bars, mask, rolling_impl=...)`` under
``torch.inference_mode()``, inside a ``TorchDispatchMode`` that records
every ATen op with the dtypes and devices of its inputs and outputs. The
per-kernel count of ATen ops is the torch form of the jaxpr fingerprint:
it is the count of kernels the op stream launches. The contracts, with
the JAX package's codes:

GL-B0  the kernel raises at the canonical shape.
GL-B1  an op count that grows with the data — the twin of the jaxpr's
       ``while``/``scan``: eager torch has no loop primitive, and what
       marks a Python loop over the data is a count that follows the
       shape. Each kernel runs a second time at :data:`GROWTH_SHAPE`
       (more days and tickers) and a third on
       :data:`SLOT_GROWTH_SESSION`'s longer day (more slots); every op
       whose count differs from the canonical run's is flagged with
       both counts.
GL-B2  any op that reads or writes ``float64``/``complex128``: the f32
       policy (the f64 oracle lives in ``oracle/``; an f64 pass inside a
       kernel doubles its bytes).
GL-B3  a host sync inside a kernel — the twin of the host callback:
       :data:`HOST_SYNC_OPS`, an index or index_put with a bool index
       (it sizes its result by the data), ``repeat_interleave`` without
       ``output_size``, and any op that copies a device tensor to the
       CPU. ``.cpu()`` of a CPU tensor dispatches nothing, so on the CPU
       only the other forms show; Tier A's GL-A3 covers ``.cpu()`` in
       source.

The hand-written kernels are ctypes calls (``kernels.py``,
``ops/rolling_cuda.py``, ``ops/pv_corr_cuda.py``), which no dispatch mode
sees: their launches are read from each wrapper's launch counter and
written into the fingerprint under one explicit key a kernel,
:data:`KERNEL_KEY` and :data:`PV_CORR_KERNEL_KEY`.

The wrapper tier holds the port's driving loops (a resident step, the
stream's minute fold, the result encode, the fast finalize and one
discovery generation) to the counterpart of "exactly one driving scan":
the ops at ``n_batches + 1`` minus those at ``n_batches`` equal one
step's ops (plus the loop's own declared bookkeeping), and the encode
and the fast finalize, which may have no loop at all, have op counts
that depend neither on ``n_batches`` nor on the session's slot count.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .violations import Violation

#: canonical trailing layout: (days, tickers, SLOTS)
SLOTS = 240
#: the (days, tickers) of GL-B1's second trace (at the canonical 240
#: slots)
GROWTH_SHAPE = (3, 5)
#: the session of GL-B1's third trace, at the canonical (days, tickers):
#: a longer day, so a loop over the slot axis shows (every kernel's op
#: count is the same on every registered session)
SLOT_GROWTH_SESSION = "us_390"

#: wide dtypes banned outside oracle/
BANNED_WIDE_DTYPES = ("float64", "complex128")
_WIDE = {getattr(torch, n): n for n in BANNED_WIDE_DTYPES}

#: op packets that wait for the device whatever their arguments: a
#: scalar read back (``aten.item`` is its spelling under inference mode),
#: results sized by the data, host-side comparisons
HOST_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.nonzero",
    "aten.masked_select", "aten.equal", "aten.is_nonzero",
})
#: op packets that sync when an index is a bool (or uint8) mask
_INDEX_OPS = frozenset({"aten.index", "aten.index_put", "aten.index_put_",
                        "aten._index_put_impl_"})

#: the fingerprint keys of the hand-written kernels' launches: the
#: rolling second moments and the six price-volume correlations
KERNEL_KEY = "kernel:second_moments"
PV_CORR_KERNEL_KEY = "kernel:pv_corr"


def _kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launches so far, by fingerprint key."""
    from ..ops import pv_corr_cuda, rolling_cuda

    return {KERNEL_KEY: sum(rolling_cuda.launches.values()),
            PV_CORR_KERNEL_KEY: pv_corr_cuda.launches}


def _packet(func) -> str:
    return f"{func.namespace}.{func.overloadpacket.__name__}"


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class OpRecorder(TorchDispatchMode):
    """Counts every ATen op that reaches the dispatcher, and notes the
    ones that touch a wide dtype or wait for the device. Nothing here
    reads a tensor's values, so recording never syncs. The ``profiler``
    namespace (a span's ``record_function`` entry and exit) computes
    nothing and launches nothing, and is not counted."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.wide: collections.Counter = collections.Counter()
        self.syncs: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "profiler":
            return out
        name = str(func)
        self.ops[name] += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for dt in sorted({_WIDE[t.dtype] for t in ins + outs
                          if t.dtype in _WIDE}):
            self.wide[(dt, name)] += 1
        sync = _sync_symbol(func, name, args, kwargs, ins, outs)
        if sync is not None:
            self.syncs[sync] += 1
        return out


def _sync_symbol(func, name, args, kwargs, ins, outs) -> Optional[str]:
    """The GL-B3 symbol of one op, or None when it does not wait."""
    packet = _packet(func)
    if packet in HOST_SYNC_OPS or packet.startswith(("aten.unique",
                                                     "aten._unique")):
        return name
    if packet in _INDEX_OPS and len(args) > 1:
        idx = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        if any(isinstance(i, torch.Tensor)
               and i.dtype in (torch.bool, torch.uint8) for i in idx):
            return f"{name}[bool]"
    if packet == "aten.repeat_interleave" \
            and kwargs.get("output_size") is None:
        return name
    src = {t.device.type for t in ins} - {"cpu", "meta"}
    if src and any(t.device.type == "cpu" for t in outs):
        return f"{name}[{sorted(src)[0]}->cpu]"
    return None


class OpTrace:
    """What one traced call did: ATen op counts, wide-dtype and sync
    ops, the hand-written kernels' launches (``kernel_launches`` by key,
    ``launches`` their sum) and the rolling backend's ``(requested,
    resolved)`` calls."""

    def __init__(self, rec: OpRecorder, kernel_launches: Dict[str, int],
                 impl_counts: Dict[Tuple[str, str], int]):
        self.ops = dict(rec.ops)
        self.wide = dict(rec.wide)
        self.syncs = dict(rec.syncs)
        self.kernel_launches = {k: n for k, n in kernel_launches.items()
                                if n}
        self.launches = sum(self.kernel_launches.values())
        self.impl_counts = impl_counts

    def counts(self) -> Dict[str, int]:
        """The fingerprint's op counts: the ATen ops, and each kernel's
        launches under its key when it ran."""
        out = dict(self.ops)
        out.update(self.kernel_launches)
        return dict(sorted(out.items()))

    def fingerprint(self) -> Dict:
        return {"traced": True, "n_ops": sum(self.ops.values()),
                "ops": self.counts()}


def trace(fn: Callable[[], object]) -> Tuple[object, OpTrace]:
    """Run ``fn()`` under inference mode inside an :class:`OpRecorder`;
    returns its result and the :class:`OpTrace`."""
    from ..ops import rolling

    before = _kernel_launches()
    impl_before = dict(rolling.IMPL_COUNTS)
    rec = OpRecorder()
    with torch.inference_mode(), rec:
        out = fn()
    impl = {k: n - impl_before.get(k, 0)
            for k, n in rolling.IMPL_COUNTS.items()
            if n != impl_before.get(k, 0)}
    launched = {k: n - before[k] for k, n in _kernel_launches().items()}
    return out, OpTrace(rec, launched, impl)


def canonical_inputs(days: int = 2, tickers: int = 3, device="cpu",
                     n_slots: int = SLOTS, seed: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded ``(bars [days, tickers, n_slots, 5] f32, mask bool)`` on
    ``device``: a close random walk, open/high/low around it, positive
    volumes, 5% of the bars absent (zeroed)."""
    bars, mask = host_inputs(days, tickers, n_slots, seed)
    return (torch.from_numpy(bars).to(device),
            torch.from_numpy(mask).to(device))


def host_inputs(days: int, tickers: int, n_slots: int = SLOTS,
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The host numpy arrays of :func:`canonical_inputs`."""
    rng = np.random.default_rng([seed, days, tickers, n_slots])
    shape = (days, tickers, n_slots)
    close = 10.0 * np.exp(np.cumsum(rng.standard_normal(shape) * 1e-3,
                                    axis=-1))
    open_ = close * np.exp(rng.standard_normal(shape) * 1e-4)
    wick = np.abs(rng.standard_normal(shape)) * 1e-4
    high = np.maximum(open_, close) * (1.0 + wick)
    low = np.minimum(open_, close) * (1.0 - wick)
    volume = rng.integers(1, 10_000, shape).astype(np.float64)
    mask = rng.random(shape) > 0.05
    bars = np.stack([open_, high, low, close, volume], axis=-1)
    bars = np.where(mask[..., None], bars, 0.0).astype(np.float32)
    return bars, mask


# --------------------------------------------------------------------------
# the kernel tier
# --------------------------------------------------------------------------


def trace_kernel(fn: Callable, bars, mask, rolling_impl: str = "torch",
                 session=None) -> Tuple[object, OpTrace]:
    """Run ``fn(DayContext(bars, mask, rolling_impl=...))`` under the
    recorder (``session``: the day's market session, None the canonical
    one)."""
    from ..models.context import DayContext

    return trace(lambda: fn(DayContext(bars, mask,
                                       rolling_impl=rolling_impl,
                                       session=session)))


def _contract_violations(name: str, t: OpTrace, what: str
                         ) -> List[Violation]:
    """GL-B2 and GL-B3 of one trace. GL-B2 is one finding per wide dtype
    (its symbol), its message naming the ops: the baseline then keys on
    the dtype and the kernel, not on op names a torch release may
    spell otherwise."""
    out = []
    by_dtype: Dict[str, List[str]] = {}
    for (dt, op), n in sorted(t.wide.items()):
        by_dtype.setdefault(dt, []).append(f"{n}x {op}")
    for dt, ops in by_dtype.items():
        out.append(Violation(
            code="GL-B2", path="", line=0, symbol=dt,
            message=f"{', '.join(ops)} read or write {dt} inside {what}: "
                    "wide dtypes belong to oracle/ only (f32 policy)",
            kernel=name))
    for sym, n in sorted(t.syncs.items()):
        out.append(Violation(
            code="GL-B3", path="", line=0, symbol=sym,
            message=f"{n}x {sym} inside {what}: a host sync stalls the "
                    "launch queue (and fails under torch.cuda."
                    "set_sync_debug_mode('error')); keep the value on the "
                    "device, size results statically", kernel=name))
    return out


def check_kernel(name: str, fn: Callable, days: int = 2, tickers: int = 3,
                 rolling_impl: str = "torch", device="cpu"
                 ) -> Tuple[List[Violation], Dict]:
    """Contracts + fingerprint for one kernel. A kernel that raises at
    the canonical shape is itself a violation (GL-B0)."""
    shape = (days, tickers, SLOTS)
    try:
        _, t = trace_kernel(fn, *canonical_inputs(days, tickers, device),
                            rolling_impl)
    except Exception as e:  # noqa: BLE001 — the failure IS the finding
        return [Violation(code="GL-B0", path="", line=0,
                          symbol=f"{type(e).__name__}",
                          message=f"kernel failed to run at {shape}: {e}",
                          kernel=name)], {"traced": False}
    out = _contract_violations(name, t, "the kernel")
    from ..markets import get_session

    longer = get_session(SLOT_GROWTH_SESSION)
    for (d, k), sess in ((GROWTH_SHAPE, None), ((days, tickers), longer)):
        grown = (d, k, SLOTS if sess is None else sess.n_slots)
        try:
            _, g = trace_kernel(fn, *canonical_inputs(
                d, k, device, n_slots=grown[2]), rolling_impl, sess)
        except Exception as e:  # noqa: BLE001 — the failure IS the finding
            out.append(Violation(code="GL-B0", path="", line=0,
                                 symbol=f"{type(e).__name__}",
                                 message=f"kernel failed to run at "
                                         f"{grown}: {e}", kernel=name))
        else:
            out += growth_violations(name, t.counts(), g.counts(), shape,
                                     grown, "the kernel")
    return out, t.fingerprint()


def growth_violations(name: str, small: Dict[str, int],
                      large: Dict[str, int], small_shape, large_shape,
                      what: str) -> List[Violation]:
    """GL-B1: every op whose count differs between two shapes."""
    out = []
    for op in sorted(set(small) | set(large)):
        a, b = small.get(op, 0), large.get(op, 0)
        if a != b:
            out.append(Violation(
                code="GL-B1", path="", line=0, symbol=op,
                message=f"{a}x {op} at {tuple(small_shape)} against {b}x "
                        f"at {tuple(large_shape)} inside {what}: an op "
                        "count that follows the data is a Python loop "
                        "over it (one launch chain per element); use one "
                        "batched op over the axis", kernel=name))
    return out


def run_trace_tier(names: Optional[Sequence[str]] = None, days: int = 2,
                   tickers: int = 3, rolling_impl: str = "torch",
                   device="cpu") -> Tuple[List[Violation], Dict[str, Dict]]:
    """Check every registered kernel (default: the canonical 58)."""
    from ..models import registry

    if names is None:
        names = registry.factor_names()
    violations: List[Violation] = []
    fingerprints: Dict[str, Dict] = {}
    for n in names:
        vs, fp = check_kernel(n, registry.resolve(n), days=days,
                              tickers=tickers, rolling_impl=rolling_impl,
                              device=device)
        violations += vs
        fingerprints[n] = fp
    return violations, fingerprints


# --------------------------------------------------------------------------
# driving-loop wrappers
# --------------------------------------------------------------------------

#: the port's driving-loop entry points (the JAX package's
#: ``RESIDENT_WRAPPERS`` less the sharded and 2-D scans, which need a
#: process group): a resident step of ``pipeline.compute_packed_resident``,
#: the stream's minute fold ``stream.engine.scan_update``, the result
#: wire's ``encode_block``, the fast finalize
#: ``stream.fastpath.stream_finalize_fast`` and one discovery generation
#: ``research.fitness.generation_fitness`` (its loop is over population
#: chunks)
RESIDENT_WRAPPERS = ("__resident_scan__", "__stream_update__",
                     "__result_encode__", "__stream_finalize_fast__",
                     "__discover_generation__")

#: driving loops allowed per wrapper symbol (default 1): the encode and
#: the fast finalize must have none, so their op counts may not depend on
#: ``n_batches`` at all
WRAPPER_SCAN_ALLOWANCE = {"__result_encode__": 0,
                          "__stream_finalize_fast__": 0}

#: factor subset the wrapper traces drive: a plain reduction, the
#: rolling family, and the one cross-sectional rank
RESIDENT_TRACE_NAMES = ("vol_return1min", "mmt_ols_qrs", "doc_pdf60")

#: wrappers re-traced per REGISTERED session: the resident step and the
#: minute fold follow the slot count; the encode and the fast finalize
#: must not (equal per-session fingerprints are the evidence that they
#: are O(1) in the session's length)
SESSION_TRACE_WRAPPERS = ("__resident_scan__", "__stream_update__",
                          "__stream_finalize_fast__", "__result_encode__")

#: population chunk and chunks per n_batches of the discovery trace
DISCOVER_CHUNK = 2


class _Wrapper:
    """One wrapper's traced call at ``n`` driving steps (``call(n)``) and
    the loop's step ``n`` (0-based) traced alone (``step(n)``, with the
    loop's own bookkeeping ops per step in ``step_extra``)."""

    def __init__(self, call, step=None, step_extra=None):
        self.call = call
        self.step = step
        self.step_extra = step_extra or {}


def _resident_wrapper(days, tickers, session, device, rolling_impl):
    from .. import pipeline
    from ..data import wire

    bars, mask = host_inputs(days, tickers, session.n_slots)
    buf, spec = wire.pack_arrays((bars, mask.astype(np.uint8)))
    names = RESIDENT_TRACE_NAMES

    def bufs(n):
        return [torch.from_numpy(buf).to(device) for _ in range(n)]

    def call(n):
        b = bufs(n)
        return trace(lambda: pipeline.compute_packed_resident(
            b, spec, "raw", names, True, rolling_impl, session=session,
            device=device))[1]

    def step(n):
        (b,) = bufs(1)
        return trace(lambda: pipeline._packed_step(
            b, spec, "raw", names, True, rolling_impl, None, False,
            session))[1]

    # the loop's own per-step ops: the result written into its slot of
    # the preallocated output (``out[i] = y``), and, where the buffers
    # are donated, the buffer's stream record
    extra = {"aten.select.int": 1, "aten.copy_.default": 1}
    if pipeline._donate_device_buffers(None, torch.device(device)):
        extra["aten.record_stream.default"] = 1
    return _Wrapper(call, step, extra)


def _fold_inputs(n, tickers, session, device, seed=1):
    bars, mask = host_inputs(1, tickers, session.n_slots, seed)
    b = torch.from_numpy(np.ascontiguousarray(
        bars[0, :, :n].transpose(1, 0, 2))).to(device)
    p = torch.from_numpy(np.ascontiguousarray(mask[0, :, :n].T)).to(device)
    return b, p


def _fresh_carry(tickers, session, device):
    from ..stream import carry as carry_mod
    return carry_mod.carry_to_device(
        carry_mod.init_carry(tickers, session=session), device)


def _stream_wrapper(tickers, session, device):
    from ..stream import carry as carry_mod
    from ..stream.engine import scan_update

    def call(n):
        c = _fresh_carry(tickers, session, device)
        b, p = _fold_inputs(n, tickers, session, device)
        return trace(lambda: scan_update(c, b, p, session=session))[1]

    def step(n):
        # minute n on a carry that already holds minutes 0..n-1: the
        # update reads its slot's window membership off the cursor, so
        # its ops follow the minute
        c = _fresh_carry(tickers, session, device)
        b, p = _fold_inputs(n + 1, tickers, session, device)
        with torch.inference_mode():
            c = scan_update(c, b[:n], p[:n], session=session)
        bn, pn = b[n], p[n]
        return trace(lambda: carry_mod.update_minute(
            c, bn, pn, session=session))[1]

    # the loop's own per-step ops: the minute's slices of the inputs
    return _Wrapper(call, step, {"aten.select.int": 2})


def _finalize_wrapper(tickers, session, device):
    from ..models.registry import factor_names
    from ..stream import fastpath
    from ..stream.engine import scan_update

    fold_names, _ = fastpath.partition_names(factor_names())

    def call(n):
        c = _fresh_carry(tickers, session, device)
        b, p = _fold_inputs(n, tickers, session, device)
        with torch.inference_mode():
            c = scan_update(c, b, p, session=session)
        return trace(lambda: fastpath.stream_finalize_fast(
            c["inc"], fold_names))[1]

    return _Wrapper(call)


def _encode_wrapper(tickers, device):
    from ..data import result_wire

    names = RESIDENT_TRACE_NAMES

    def call(n):
        # a block of n days: what a resident step of n days hands it
        spec = result_wire.ResultWireSpec.for_names(names, days=n)
        g = torch.Generator().manual_seed(n)
        x = torch.randn((len(names), n, tickers), generator=g).to(device)
        return trace(lambda: result_wire.encode_block(x, spec))[1]

    return _Wrapper(call)


def _plan_index_arrays(plan) -> int:
    """Index arrays of one host plan: each is one view of the shared
    upload (``search.upload_plans``)."""
    n = 0
    for entry in plan:
        if isinstance(entry, np.ndarray):
            n += 1
        elif isinstance(entry, list):
            n += sum(rows is not None for _, rows in entry)
    return n


def _discover_wrapper(days, tickers, device):
    from .. import search
    from ..research import fitness

    bars, mask = host_inputs(days, tickers)
    fr, fv = fitness.host_forward_returns(bars, mask)
    b = torch.from_numpy(bars).to(device)
    m = torch.from_numpy(mask).to(device)
    fwd_ret = torch.from_numpy(fr).to(device)
    fwd_valid = torch.from_numpy(fv).to(device)
    with torch.inference_mode():
        feats = search._features(b, m)
    skel = search.DEFAULT_SKELETON
    # every chunk holds the same candidates, so each costs the same ops
    block = search.random_population(np.random.default_rng(0),
                                     DISCOVER_CHUNK, skel)
    host_plan = search.slot_groups(block, skel)

    def call(n):
        g = np.tile(block, (n, 1))
        return trace(lambda: fitness.generation_fitness(
            g, feats, m, fwd_ret, fwd_valid, skel, group_num=5,
            chunk=DISCOVER_CHUNK, n_elite=2))[1]

    def step(n):
        (plan,) = search.upload_plans([host_plan], device)
        return trace(lambda: fitness._candidate_stats(
            search.evaluate_plan(plan, feats, m, skel, DISCOVER_CHUNK),
            fwd_ret, fwd_valid, 5))[1]

    # the loop's own per-step ops: the chunk's views of the one upload
    return _Wrapper(call, step,
                    {"aten.slice.Tensor": _plan_index_arrays(host_plan)})


def _wrappers(names: Sequence[str], days: int, tickers: int, session,
              device, rolling_impl: str) -> Dict[str, _Wrapper]:
    from ..markets import get_session

    session = get_session(session)
    build = {
        "__resident_scan__": lambda: _resident_wrapper(
            days, tickers, session, device, rolling_impl),
        "__stream_update__": lambda: _stream_wrapper(tickers, session,
                                                     device),
        "__result_encode__": lambda: _encode_wrapper(tickers, device),
        "__stream_finalize_fast__": lambda: _finalize_wrapper(
            tickers, session, device),
        "__discover_generation__": lambda: _discover_wrapper(
            days, tickers, device),
    }
    return {n: build[n]() for n in names}


def add_counts(a: Dict[str, int], b: Dict[str, int], sign: int = 1
               ) -> Dict[str, int]:
    """``a + sign * b`` over op counts, zero counts dropped."""
    out = {k: a.get(k, 0) + sign * b.get(k, 0) for k in set(a) | set(b)}
    return {k: v for k, v in sorted(out.items()) if v}


def check_wrapper(name: str, w: _Wrapper, n_batches: int = 2
                  ) -> Tuple[List[Violation], Dict]:
    """The kernel contracts adapted to a driving loop: GL-B2/GL-B3 on the
    trace at ``n_batches``; GL-B1 becomes "one more step costs exactly
    one step" (allowance 1: the ops at ``n_batches + 1`` less those at
    ``n_batches`` equal the step's ops plus the loop's declared per-step
    ops) or "no loop" (allowance 0: equal op counts at both)."""
    t = w.call(n_batches)
    t_next = w.call(n_batches + 1)
    out = _contract_violations(name, t, "the wrapper")
    allowed = WRAPPER_SCAN_ALLOWANCE.get(name.rsplit(":", 1)[-1], 1)
    if allowed == 0:
        out += growth_violations(name, t.counts(), t_next.counts(),
                                 (n_batches,), (n_batches + 1,),
                                 "a wrapper that may have no loop")
    else:
        got = add_counts(t_next.counts(), t.counts(), -1)
        want = add_counts(w.step(n_batches).counts(), w.step_extra)
        for op in sorted(set(got) | set(want)):
            if got.get(op, 0) != want.get(op, 0):
                out.append(Violation(
                    code="GL-B1", path="", line=0, symbol=op,
                    message=f"one more driving step adds {got.get(op, 0)}"
                            f"x {op} where one step has {want.get(op, 0)}"
                            "x: the wrapper's loop does more than its one "
                            "step per batch (a second loop leaking "
                            "through)", kernel=name))
    return out, t.fingerprint()


def run_resident_tier(n_batches: int = 2, days: int = 2, tickers: int = 3,
                      rolling_impl: str = "torch", device="cpu"
                      ) -> Tuple[List[Violation], Dict[str, Dict]]:
    """Contracts + fingerprints for the driving-loop wrappers at the
    canonical session. A wrapper that raises is a GL-B0 finding, as a
    kernel is."""
    names = RESIDENT_WRAPPERS
    violations: List[Violation] = []
    fingerprints: Dict[str, Dict] = {}
    try:
        wrappers = _wrappers(names, days, tickers, None, device,
                             rolling_impl)
    except Exception as e:  # noqa: BLE001 — the failure IS the finding
        wrappers = {n: e for n in names}
    for name in names:
        w = wrappers[name]
        try:
            if isinstance(w, Exception):
                raise w
            vs, fp = check_wrapper(name, w, n_batches)
        except Exception as e:  # noqa: BLE001 — the failure IS the finding
            vs = [Violation(code="GL-B0", path="", line=0,
                            symbol=f"{type(e).__name__}",
                            message=f"wrapper failed to run at ({days}, "
                                    f"{tickers}, {SLOTS}): {e}",
                            kernel=name)]
            fp = {"traced": False}
        violations += vs
        fingerprints[name] = fp
    return violations, fingerprints


def run_session_tier(n_batches: int = 2, days: int = 2, tickers: int = 3,
                     rolling_impl: str = "torch", device="cpu"
                     ) -> Tuple[List[Violation],
                                Dict[str, Dict[str, Dict]]]:
    """Per-session wrapper contracts + fingerprints: every REGISTERED
    session's ``(days, tickers, n_slots)`` traced under the same
    contracts, and the encode's and the fast finalize's fingerprints
    equal across sessions (GL-B1 on the wrapper otherwise)."""
    from ..markets import session_names

    violations: List[Violation] = []
    fingerprints: Dict[str, Dict[str, Dict]] = {}
    for sname in session_names():
        rows: Dict[str, Dict] = {}
        try:
            wrappers = _wrappers(SESSION_TRACE_WRAPPERS, days, tickers,
                                 sname, device, rolling_impl)
            for wname, w in wrappers.items():
                vs, fp = check_wrapper(f"{sname}:{wname}", w, n_batches)
                violations += vs
                rows[wname] = fp
        except Exception as e:  # noqa: BLE001 — the failure IS the finding
            for wname in SESSION_TRACE_WRAPPERS:
                violations.append(Violation(
                    code="GL-B0", path="", line=0,
                    symbol=f"{type(e).__name__}",
                    message=f"session {sname!r} wrapper failed to run at "
                            f"({days}, {tickers}, session.n_slots): {e}",
                    kernel=f"{sname}:{wname}"))
            rows = {w: {"traced": False} for w in SESSION_TRACE_WRAPPERS}
        fingerprints[sname] = rows
    for wname, allowed in WRAPPER_SCAN_ALLOWANCE.items():
        if allowed or wname not in SESSION_TRACE_WRAPPERS:
            continue
        per = {s: rows[wname] for s, rows in fingerprints.items()
               if rows[wname].get("traced")}
        if len({repr(fp) for fp in per.values()}) > 1:
            first = next(iter(per))
            for s, fp in per.items():
                violations += growth_violations(
                    f"{s}:{wname}", per[first]["ops"], fp["ops"],
                    (first,), (s,), "a wrapper that must not follow the "
                    "session's slot count")
    return violations, fingerprints
